"""Tooling around the envs: path helpers, min-jerk plans, curriculum, MJCF
surgery, inverse kinematics and the examine command lines."""

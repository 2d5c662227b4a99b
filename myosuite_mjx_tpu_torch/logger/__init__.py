"""Reference motions for the tracking tasks, and rollout traces."""

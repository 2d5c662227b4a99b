"""examine_reference CLI: kinematic playback of a tracking task's reference.

Counterpart of ``myosuite_mjx_tpu/utils/examine_reference.py``: the qpos
frames of a tracking env's reference clip (the robot's joints, the
object's position and Euler angles) with no dynamics, and their spans.
The frames are one batched lookup on the card unless ``--device cpu``.
The JAX command's ``--render`` path is left out: it goes through
``utils/render.py``, which needs MuJoCo's renderer.

Usage:
  python -m myosuite_mjx_tpu_torch.utils.examine_reference \\
      -e track29CubesmallLift-v0
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from myosuite_mjx_tpu_torch.logger.reference_motion import ReferenceType
from myosuite_mjx_tpu_torch.ops import quat as qmath


def playback_qpos(env, horizon: int, device="cuda") -> np.ndarray:
  """Kinematic qpos frames [horizon, nq] of the env's reference clip at
  its control steps (a RANDOM reference takes one draw)."""
  rd = env.ref.robot_dim
  dt = env.model.opt.timestep * env.frame_skip
  times = (torch.arange(horizon, dtype=torch.float64, device=device) * dt
           + env.motion_start_time)
  draws = (env.ref.draw(1, torch.Generator(device=device).manual_seed(0),
                        device)
           if env.ref.type == ReferenceType.RANDOM else None)
  if draws is not None:
    draws = {k: None if v is None else v.expand(horizon, -1)
             for k, v in draws.items()}
  ref = env.ref.get_reference(times.to(env.ref.dtype), draws)
  frames = np.tile(env.init_qpos, (horizon, 1))
  frames[:, :rd] = ref["robot"].double().cpu().numpy()
  obj = ref["object"].double()
  frames[:, rd:rd + 3] = obj[:, :3].cpu().numpy()
  frames[:, -3:] = qmath.quat_to_euler(obj[:, 3:7]).cpu().numpy()
  return frames


def main(argv=None) -> np.ndarray:
  ap = argparse.ArgumentParser()
  ap.add_argument("--env_name", "-e", default="track29CubesmallLift-v0")
  ap.add_argument("--horizon", type=int, default=-1)
  ap.add_argument("--num_playback", "-n", type=int, default=1)
  ap.add_argument("--device", default="cuda")
  args = ap.parse_args(argv)

  from myosuite_mjx_tpu_torch import envs
  env = envs.make(args.env_name)
  horizon = args.horizon if args.horizon > 0 else int(env.ref.horizon)
  print(f"Rendering reference motion (total frames: {horizon})")
  rd = env.ref.robot_dim
  for n in range(args.num_playback):
    frames = playback_qpos(env, horizon, args.device)
    span = frames.max(axis=0) - frames.min(axis=0)
    print(f"playback {n}: {frames.shape[0]} frames, "
          f"max joint span {span[:rd].max():.3f} rad, "
          f"object travel {np.linalg.norm(span[rd:rd + 3]):.3f} m")
  return frames


if __name__ == "__main__":
  main()

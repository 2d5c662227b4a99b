"""Where the batched env step's time goes, on one CUDA card.

    python -m myosuite_mjx_tpu_torch.tools.profile_step [--batch 4096]

Runs the hand23 pose task (myoHandPoseFixed-v0 kwargs) and prints:

- per engine stage, the host wall time of one call at the batch size,
  between two ``torch.cuda.synchronize()`` (so launch overhead counts),
  and the number of kernels the stage launches (profiler count);
- over a profiled window of control steps, wall time, summed device
  kernel time and the device's idle share (1 - kernel time / wall);
- the kernels with the most device time.

With ``--table PATH`` it also writes the full profiler table to PATH.
"""
from __future__ import annotations

import argparse
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

from myosuite_mjx_tpu_torch.engine import collision, constraint, forward
from myosuite_mjx_tpu_torch.engine import solver
from myosuite_mjx_tpu_torch.envs.base import BatchedEnv
from myosuite_mjx_tpu_torch.envs.pose import HAND_POSE_FIXED, PoseEnv

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _device_us(prof) -> float:
  return sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)


def _kernels(prof) -> int:
  return sum(e.count for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)


def _stage(name, fn, reps=10):
  fn()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for _ in range(reps):
    fn()
  torch.cuda.synchronize()
  ms = (time.perf_counter() - t0) / reps * 1e3
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    fn()
    torch.cuda.synchronize()
  print(f"stage {name:<22} {ms:8.3f} ms  kernels {_kernels(prof):5d}  "
        f"device {_device_us(prof) / 1e3:8.3f} ms", flush=True)


def main(argv=None) -> None:
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--batch", type=int, default=4096)
  ap.add_argument("--steps", type=int, default=3)
  ap.add_argument("--table", help="file for the full profiler table")
  args = ap.parse_args(argv)
  env = PoseEnv(os.path.join(ROOT, "myosuite_mjx_tpu_torch", "assets",
                             "hand23.npz"), **HAND_POSE_FIXED)
  benv = BatchedEnv(env, args.batch, "cuda", seed=0)
  g = torch.Generator(device="cuda").manual_seed(0)
  act = lambda: torch.rand((args.batch, env.action_dim), generator=g,
                           device="cuda")
  st = benv.init()
  for _ in range(3):
    st = benv.step(st, act())
  m, d = env.device_model("cuda"), st.data
  d_pos = forward.fwd_position(m, d, False)
  d_vel = forward.fwd_velocity(m, d_pos)
  d_act = forward.fwd_passive(m, forward.fwd_actuation(m, d_vel))
  d_acc = forward.fwd_acceleration(m, d_act, False)
  blocks, _ = collision.contacts(m, d_acc)
  efc = constraint.make_efc(m, d_acc, blocks)
  d_con = forward.forward(m, d, full_data=False)
  iters = int(m.opt.solver_iterations), int(m.opt.ls_iterations)
  print(f"card {torch.cuda.get_device_name(0)}, batch {args.batch}")
  _stage("fwd_position", lambda: forward.fwd_position(m, d, False))
  _stage("fwd_velocity", lambda: forward.fwd_velocity(m, d_pos))
  _stage("fwd_actuation+passive", lambda: forward.fwd_passive(
      m, forward.fwd_actuation(m, d_vel)))
  _stage("fwd_acceleration", lambda: forward.fwd_acceleration(m, d_act,
                                                              False))
  _stage("contacts", lambda: collision.contacts(m, d_acc))
  _stage("make_efc", lambda: constraint.make_efc(m, d_acc, blocks))
  _stage("newton_solve", lambda: solver._newton_solve(
      m, d_acc, efc[0], efc[1], efc[2], efc[3], *iters))
  _stage("euler", lambda: forward.euler(m, d_con))
  _stage("substep (step)", lambda: forward.step(m, d, full_data=False))
  _stage("env step (autoreset)", lambda: benv.step(st, act()), reps=3)

  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
    t0 = time.perf_counter()
    for _ in range(args.steps):
      st = benv.step(st, act())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
  busy = _device_us(p) / 1e6
  print(f"profiled {args.steps} control steps: wall {wall:.3f} s, device "
        f"kernel time {busy:.3f} s, device idle share {1 - busy / wall:.3f}, "
        f"kernels launched {_kernels(p)}")
  table = p.key_averages().table(sort_by="self_cuda_time_total",
                                 row_limit=40)
  print("\n".join(table.splitlines()[:25]))
  if args.table:
    os.makedirs(os.path.dirname(os.path.abspath(args.table)), exist_ok=True)
    with open(args.table, "w") as f:
      f.write(p.key_averages().table(sort_by="self_cuda_time_total",
                                     row_limit=200))


if __name__ == "__main__":
  main()

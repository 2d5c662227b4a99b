"""Where the batched env step's time goes, on one CUDA card, by span.

    python -m myosuite_mjx_tpu_torch.tools.profile_step [--batch 4096]
        [--steps 3] [--env hand23ObjHoldRandom-v0] [--table PATH]

Runs a task id of the port's registry (default ``hand23PoseFixed-v0``, the
hand23 pose task with myoHandPoseFixed-v0's kwargs), warms it, profiles one
window of ``--steps`` control steps and prints:

- per span of the port (``utils/spans.py``: the stages of the control step
  and, inside ``engine.contacts``, one per narrowphase type group, named by
  its geom types, e.g. ``contacts.CAPSULE-MESH``), per control step: its
  calls, host ms (the span's wall on the host, the profiler's cost
  included) and device ms (the kernels launched inside it). A stage's row
  counts every call, those of the reset's forward pass too, which also
  sit inside ``env.reset``'s row;
- the Newton solves' useful share (``spans.newton_work``), the share of
  their constraint rows holding force (``spans.efc_row_use``) and the
  share of the fresh resets kept (``spans.reset_use``);
- the kernels with the most device time.

The device's idle share, and the idle time by span, are the benchmark's
(``device_idle_share.env`` and ``idle_share.*``, ``benchmark/run.py
--trace 1``). With ``--table PATH`` it also writes the full profiler table
to PATH.
"""
from __future__ import annotations

import argparse
import os

import torch
from torch.profiler import ProfilerActivity, profile

from myosuite_mjx_tpu_torch import envs
from myosuite_mjx_tpu_torch.envs.base import BatchedEnv
from myosuite_mjx_tpu_torch.utils import spans


def span_rows(prof, steps: int) -> list:
  """(name, calls, host ms, device ms) per control step of every span in
  ``prof``: the top-level ones in the control step's order, then the group
  spans by device time."""
  found = {e.key: e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CPU
           and (e.key in spans.TOP_LEVEL or e.key.startswith(spans.GROUP))}
  top = [found[n] for n in spans.TOP_LEVEL if n in found]
  groups = sorted((e for n, e in found.items() if n.startswith(spans.GROUP)),
                  key=lambda e: -e.device_time_total)
  return [(e.key, e.count / steps, e.cpu_time_total / steps / 1e3,
           e.device_time_total / steps / 1e3) for e in top + groups]


def main(argv=None) -> None:
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--batch", type=int, default=4096)
  ap.add_argument("--steps", type=int, default=3)
  ap.add_argument("--env", default="hand23PoseFixed-v0",
                  help="task id (envs.registry_ids())")
  ap.add_argument("--table", help="file for the full profiler table")
  args = ap.parse_args(argv)
  env = envs.make(args.env)
  benv = BatchedEnv(env, args.batch, "cuda", seed=0)
  g = torch.Generator(device="cuda").manual_seed(0)
  act = lambda: torch.rand((args.batch, env.action_dim), generator=g,
                           device="cuda")
  st = benv.init()
  for _ in range(3):
    st = benv.step(st, act())
  actions = [act() for _ in range(args.steps)]
  print(f"card {torch.cuda.get_device_name(0)}, {args.env}, batch "
        f"{args.batch}, nv {env.model.nv}, frame_skip {env.frame_skip}")

  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
    for a in actions:
      st = benv.step(st, a)
    torch.cuda.synchronize()
  print(f"per control step, over {args.steps}:")
  print(f"  {'span':<28} {'calls':>7} {'host ms':>9} {'device ms':>10}")
  for name, calls, host_ms, dev_ms in span_rows(p, args.steps):
    print(f"  {name:<28} {calls:7.1f} {host_ms:9.3f} {dev_ms:10.3f}")
  useful, run = spans.newton_work()
  if run:
    print(f"Newton useful share {100.0 * useful / run:.1f}% ({useful} of "
          f"{run} env-iterations)")
  used, carried = spans.efc_row_use()
  if carried:
    print(f"constraint rows in force {100.0 * used / carried:.1f}% ({used} "
          f"of {carried} env-rows)")
  kept, computed = spans.reset_use()
  if computed:
    print(f"resets kept {100.0 * kept / computed:.2f}% ({kept} of "
          f"{computed} computed)")
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

"""Where the batched env step's time goes, on one CUDA card, by span.

    python -m myosuite_mjx_tpu_torch.tools.profile_step [--batch 4096]
        [--steps 3] [--env hand23ObjHoldRandom-v0] [--model-path SCENE]
        [--table PATH]

Runs a task id of the port's registry (default ``hand23PoseFixed-v0``, the
hand23 pose task with myoHandPoseFixed-v0's kwargs), on its own scene or
on ``--model-path`` (a scene ``.npz``, such as the benchmark's
``benchmark/configs/legs80.npz`` under ``legs80Walk-v0``), warms it,
profiles one window of ``--steps`` control steps and prints:

- per span of the port (``utils/spans.py``: the stages of the control step
  and, inside ``engine.contacts``, one per narrowphase type group, named by
  its geom types, e.g. ``contacts.CAPSULE-MESH``), per control step: its
  calls, host ms (the span's wall on the host, the profiler's cost
  included), device ms and device operations (kernels, a replayed
  graph's included, memcpy and memset: ``span_device``). A stage's row
  counts every call, those of the reset's forward pass too, which also
  sit inside ``env.reset``'s row; then the device's busy ms and
  operations of the whole window;
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
import bisect
import os

import torch
from torch.profiler import ProfilerActivity, profile

from myosuite_mjx_tpu_torch import envs
from myosuite_mjx_tpu_torch.envs.base import BatchedEnv
from myosuite_mjx_tpu_torch.utils import spans


def _is_span(name: str) -> bool:
  return name in spans.TOP_LEVEL or name.startswith(spans.GROUP)


def span_device(prof) -> tuple[dict, float, int]:
  """(device ms and operations of each span, summed over its calls; all
  device ms; all operations) of ``prof``.

  The profiler marks each span on the device's timeline too, from the
  first to the last device operation launched inside it. An operation
  belongs to every span whose mark holds it, so a stage of the reset's
  forward pass counts in its stage and in ``env.reset``. This sees the
  kernels of a replayed CUDA graph, which the host's events do not list.
  """
  marks: dict = {}
  ops = []
  for e in prof.events():
    if e.device_type == torch.autograd.DeviceType.CPU:
      continue
    if _is_span(e.name):
      marks.setdefault(e.name, []).append((e.time_range.start,
                                           e.time_range.end))
    else:
      ops.append((e.time_range.start, e.time_range.end))
  ops.sort()
  starts = [a for a, _ in ops]
  out = {}
  for name, ranges in marks.items():
    us = n = 0
    for a, b in ranges:
      for s, t in ops[bisect.bisect_left(starts, a):
                      bisect.bisect_right(starts, b)]:
        if t <= b:
          us += t - s
          n += 1
    out[name] = (us / 1e3, n)
  return out, sum(t - s for s, t in ops) / 1e3, len(ops)


def span_rows(prof, steps: int) -> list:
  """(name, calls, host ms, device ms, device operations) per control
  step of every span in ``prof`` (device ms and operations from
  ``span_device``): the top-level ones in the control step's order, then
  the group spans by device time."""
  found = {e.key: e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CPU
           and _is_span(e.key)}
  device = span_device(prof)[0]
  top = [found[n] for n in spans.TOP_LEVEL if n in found]
  groups = sorted((e for n, e in found.items() if n.startswith(spans.GROUP)),
                  key=lambda e: -device.get(e.key, (0, 0))[0])
  return [(e.key, e.count / steps, e.cpu_time_total / steps / 1e3)
          + tuple(x / steps for x in device.get(e.key, (0.0, 0)))
          for e in top + groups]


def main(argv=None) -> None:
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--batch", type=int, default=4096)
  ap.add_argument("--steps", type=int, default=3)
  ap.add_argument("--env", default="hand23PoseFixed-v0",
                  help="task id (envs.registry_ids())")
  ap.add_argument("--model-path", help="scene .npz in place of the task's")
  ap.add_argument("--table", help="file for the full profiler table")
  args = ap.parse_args(argv)
  env = (envs.make(args.env, model_path=args.model_path) if args.model_path
         else envs.make(args.env))
  benv = BatchedEnv(env, args.batch, "cuda", seed=0)
  g = torch.Generator(device="cuda").manual_seed(0)
  act = lambda: torch.rand((args.batch, env.action_dim), generator=g,
                           device="cuda")
  st = benv.init()
  for _ in range(3):
    st = benv.step(st, act())
  actions = [act() for _ in range(args.steps)]
  print(f"card {torch.cuda.get_device_name(0)}, {args.env}, batch "
        f"{args.batch}, nv {env.model.nv}, frame_skip {env.frame_skip}, "
        f"scene {args.model_path or 'of the task'}")

  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
    for a in actions:
      st = benv.step(st, a)
    torch.cuda.synchronize()
  print(f"per control step, over {args.steps}:")
  print(f"  {'span':<28} {'calls':>7} {'host ms':>9} {'device ms':>10} "
        f"{'device ops':>10}")
  for name, calls, host_ms, dev_ms, kernels in span_rows(p, args.steps):
    print(f"  {name:<28} {calls:7.1f} {host_ms:9.3f} {dev_ms:10.3f} "
          f"{kernels:10.1f}")
  _, busy_ms, ops = span_device(p)
  print(f"  {'device, whole window':<28} {'':>7} {'':>9} "
        f"{busy_ms / args.steps:10.3f} {ops / args.steps:10.1f}")
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

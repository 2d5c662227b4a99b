"""Newton-solver convergence study on a contact-rich rollout.

Counterpart of the repository's ``tools/convergence_study.py``: steps B
copies of a task's scene from qpos0 under uniform random ctrl, one per
env, and records every env's Newton iterations to convergence at the
model's tolerance each substep (``engine/solver._newton_solve`` returns
them), then prints their distribution. It is the evidence for an
iteration cap: the batch's loop runs to its slowest env. The scene comes
from a task id (default the hold task's hand and object, the port's
contact-rich scene; MyoHand itself is not in the repository).

  python -m myosuite_mjx_tpu_torch.tools.convergence_study \\
      [--env hand23ObjHoldRandom-v0] [--batch 1024] [--steps 30] \\
      [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from myosuite_mjx_tpu_torch import envs
from myosuite_mjx_tpu_torch.engine import (collision, constraint, forward,
                                           solver)
from myosuite_mjx_tpu_torch.engine import data as data_mod
from myosuite_mjx_tpu_torch.engine import model as model_mod


def step_with_iters(m: model_mod.DeviceModel, d: data_mod.Data):
  """One substep as ``forward.step``, with the Newton iterations each
  env ran [B] (0 where the scene has no constraint row)."""
  d = forward.fwd_position(m, d)
  d = forward.fwd_velocity(m, d)
  d = forward.fwd_actuation(m, d)
  d = forward.fwd_passive(m, d)
  d = forward.fwd_acceleration(m, d)
  blocks, _ = collision.contacts(m, d)
  efc = constraint.make_efc(m, d, blocks)
  if efc is None:
    d = solver.smooth_only(m, d)
    niter = torch.zeros(d.qpos.shape[0], dtype=torch.int32,
                        device=d.qpos.device)
  else:
    J, aref, D, is_eq, _pos, _meta = efc
    qacc, force, niter = solver._newton_solve(
        m, d, J, aref, D, is_eq, int(m.opt.solver_iterations),
        int(m.opt.ls_iterations))
    d = d.replace(qfrc_constraint=(J.transpose(-1, -2)
                                   @ force[..., None])[..., 0],
                  qacc=qacc, qacc_warmstart=qacc)
  return forward.euler(m, d), niter


def build_parser() -> argparse.ArgumentParser:
  ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  ap.add_argument("--batch", type=int, default=1024)
  ap.add_argument("--steps", type=int, default=30)
  ap.add_argument("--env", default="hand23ObjHoldRandom-v0",
                  help="the registered task id whose scene is stepped")
  ap.add_argument("--device", default="cuda",
                  help="torch device (default: the card)")
  return ap


def main(argv=None) -> np.ndarray:
  """Run the study as the flags say; returns the iterations [steps, B]."""
  args = build_parser().parse_args(argv)
  host = envs.make(args.env).model
  m = model_mod.DeviceModel(host, torch.float32, args.device)
  B = args.batch
  d = data_mod.make_data(m, B, torch.float32, m.device)
  # diverse ctrl per env to reach varied contact states
  g = torch.Generator().manual_seed(0)
  d = d.replace(ctrl=torch.rand((B, host.nu), generator=g).to(m.device))
  iters = []
  for _ in range(args.steps):
    d, niter = step_with_iters(m, d)
    iters.append(niter)
  it = torch.stack(iters).cpu().numpy()            # [steps, B]
  print(f"B={B} steps={args.steps} cap={host.opt.solver_iterations}")
  print(f"overall: p50={np.percentile(it, 50):.0f} "
        f"p90={np.percentile(it, 90):.0f} p99={np.percentile(it, 99):.0f} "
        f"p99.9={np.percentile(it, 99.9):.0f} max={it.max()}")
  print("per-step max:", it.max(axis=1)[:20].tolist())
  print("per-step p99:", np.percentile(it, 99, axis=1)[:20].round(1).tolist())
  # the first steps are cold (no warm start); steady state after ~5
  ss = it[5:]
  if ss.size:
    print(f"steady-state (step>=5): p99={np.percentile(ss, 99):.0f} "
          f"p99.9={np.percentile(ss, 99.9):.0f} max={ss.max()}")
  return it


if __name__ == "__main__":
  main()

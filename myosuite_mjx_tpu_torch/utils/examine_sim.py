"""examine_sim CLI: load an exported model and step the engine on it.

Counterpart of ``myosuite_mjx_tpu/utils/examine_sim.py``: a quick check of
a model outside any task env: load, step with random or zero ctrl, report
state statistics. The card's machine has no MJCF compiler, so the model is
an exported ``.npz`` (``engine/api.load``; ``python tests/torch_parity.py
--export`` writes the fixtures'). Like the JAX command it steps in float64
on the card unless ``--device cpu``. The ``--video`` flag of
the JAX command is left out: it goes through ``utils/render.py``, which
needs MuJoCo's renderer.

Usage:
  python -m myosuite_mjx_tpu_torch.utils.examine_sim \\
      --model_path myosuite_mjx_tpu_torch/assets/chain72.npz \\
      [--horizon 100] [--ctrl random|zero] [--seed 0] [--device cuda]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from myosuite_mjx_tpu_torch.engine import api


def main(argv=None) -> dict:
  ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  ap.add_argument("--model_path", "-m", required=True,
                  help="an exported .npz model")
  ap.add_argument("--horizon", type=int, default=100)
  ap.add_argument("--ctrl", default="random", choices=("random", "zero"))
  ap.add_argument("--seed", type=int, default=0)
  ap.add_argument("--device", default="cuda")
  args = ap.parse_args(argv)

  dtype = torch.float64
  phys = api.load(args.model_path, dtype, args.device)
  m = phys.model
  print(f"model: nq={m.nq} nv={m.nv} nu={m.nu} na={m.na} "
        f"nbody={m.nbody} ngeom={m.ngeom} ntendon={m.ntendon}")
  d = phys.make_data(1)
  g = torch.Generator(device=phys.device).manual_seed(args.seed)
  t0 = time.time()
  for _ in range(args.horizon):
    if args.ctrl == "random":
      ctrl = torch.rand((1, m.nu), generator=g, dtype=dtype,
                        device=phys.device)
    else:
      ctrl = torch.zeros((1, m.nu), dtype=dtype, device=phys.device)
    d = phys.step(d.replace(ctrl=ctrl))
  qpos = d.qpos[0].cpu().numpy()
  wall = time.time() - t0
  print(f"stepped {args.horizon} x {m.opt.timestep * 1e3:.0f} ms "
        f"in {wall:.2f} s wall")
  print(f"qpos range [{qpos.min():.4f}, {qpos.max():.4f}] "
        f"finite={np.isfinite(qpos).all()} "
        f"ncon_active={int(d.ne_active[0])} "
        f"ncon_dropped={int(d.ncon_dropped[0])}")
  return {"qpos": qpos, "seconds": wall, "ne_active": int(d.ne_active[0]),
          "ncon_dropped": int(d.ncon_dropped[0])}


if __name__ == "__main__":
  main()

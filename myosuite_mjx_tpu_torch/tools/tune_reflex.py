"""Population gain-tuning for the reflex walking controller (CEM).

Counterpart of the repository's ``tools/tune_reflex.py``: the 46 Song &
Geyer gains of ``agents/reflex.py`` are tuned by the cross-entropy method,
each generation a population of whole rollouts run as one batch of
walkers on the card (``legs80_reflex``, MyoLeg's names). The host draws
the candidates with ``np.random.default_rng(seed)`` as the JAX tool does,
so both tools score the same candidates; elitism keeps the best gains
ever as candidate 0.

Fitness: the pelvis x reached before falling plus 0.005 per tick alive;
a walker falls when its pelvis leaves the [0.65, 1.25] m band, tilts
past 60 degrees from its reset orientation, or fails the sanity gate
(non-finite or |qvel| >= 100, or more than 0.1 m of x in one tick). The
alive mask, the fall x and the ticks alive stay on the device: the host
reads them once per generation.

Usage:
  python -m myosuite_mjx_tpu_torch.tools.tune_reflex --generations 40 \\
      --pop 256 --out train_artifacts/reflex_gains_legs80.npz [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from myosuite_mjx_tpu_torch.agents import reflex


def upright_axis(walker: reflex.ReflexWalker, d0) -> torch.Tensor:
  """The pelvis body axis that points world-up at reset, u = R0^T e_z
  (the pelvis frame need not be upright), so that up(t) = e_z . R(t) u is
  1 standing and 0 at a 90 degree tilt."""
  r0 = d0.xmat[0, walker.pelvis_bid].double().cpu().numpy()
  return torch.as_tensor(r0.T @ np.array([0.0, 0.0, 1.0]),
                         device=d0.qpos.device).to(walker.dtype)


def score(walker: reflex.ReflexWalker, cand: np.ndarray, ticks: int,
          device="cuda"):
  """(fitness [P], ticks alive [P]) of the gain vectors ``cand`` [P, 46],
  one walker each, over ``ticks`` control ticks."""
  P = cand.shape[0]
  cp = reflex.expand_params(cand, walker.dtype, device)
  d, s = walker.reset(P, device)
  up_axis = upright_axis(walker, d)
  b = walker.pelvis_bid
  alive = torch.ones(P, dtype=torch.bool, device=d.qpos.device)
  fall_x = torch.zeros(P, dtype=walker.dtype, device=d.qpos.device)
  t_alive = torch.zeros(P, dtype=torch.int32, device=d.qpos.device)
  for _ in range(ticks):
    prev_x = d.xpos[:, b, 0]
    d, s = walker.step(d, s, cp)
    x, h = d.xpos[:, b, 0], d.xpos[:, b, 2]
    up = d.xmat[:, b, 2, :] @ up_axis
    # a diverging sim can fly through the height band: credit nothing
    # without finite, bounded joint velocities and <= 10 m/s of x
    sane = (torch.isfinite(d.qvel).all(-1)
            & (d.qvel.abs().amax(-1) < 100.0)
            & ((x - prev_x).abs() < 0.1))
    alive = alive & (h > 0.65) & (h < 1.25) & (up > 0.5) & sane
    fall_x = torch.where(alive, x, fall_x)
    t_alive = t_alive + alive.to(torch.int32)
  return fall_x + 0.005 * t_alive, t_alive


def build_parser() -> argparse.ArgumentParser:
  ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  ap.add_argument("--generations", type=int, default=40)
  ap.add_argument("--pop", type=int, default=256)
  ap.add_argument("--elite", type=int, default=32)
  ap.add_argument("--ticks", type=int, default=1000,
                  help="control ticks per rollout (10 ms each)")
  ap.add_argument("--sigma", type=float, default=0.15)
  ap.add_argument("--seed", type=int, default=0)
  ap.add_argument("--out", default="train_artifacts/reflex_gains_legs80.npz")
  ap.add_argument("--init", default=None,
                  help="npz with a 'params' array to warm-start from")
  ap.add_argument("--device", default="cuda",
                  help="torch device of the rollouts (default: the card)")
  return ap


def main(argv=None) -> dict:
  """Tune as the flags say; returns the best gains ever and the history."""
  args = build_parser().parse_args(argv)
  walker = reflex.ReflexWalker()
  rng = np.random.default_rng(args.seed)
  mu = (np.load(args.init)["params"] if args.init
        else np.ones(reflex.N_PARAMS))
  sigma = np.full(reflex.N_PARAMS, args.sigma)

  best = {"fitness": -np.inf, "params": mu.copy(), "t_alive": 0}
  history = []
  for gen in range(args.generations):
    t0 = time.time()
    cand = mu[None] + sigma[None] * rng.standard_normal(
        (args.pop, reflex.N_PARAMS))
    cand = np.clip(cand, -2.0, 4.0)
    cand[0] = best["params"]          # elitism: keep the best ever
    fit, t_alive = (x.double().cpu().numpy()
                    for x in score(walker, cand, args.ticks, args.device))
    order = np.argsort(-fit)
    elite = cand[order[:args.elite]]
    mu = elite.mean(0)
    sigma = 0.9 * sigma + 0.1 * (elite.std(0) + 0.01)
    if fit[order[0]] > best["fitness"]:
      best = {"fitness": float(fit[order[0]]),
              "params": cand[order[0]].copy(),
              "t_alive": int(t_alive[order[0]])}
    rec = dict(gen=gen, best=float(fit[order[0]]),
               elite_mean=float(fit[order[:args.elite]].mean()),
               best_ever=best["fitness"],
               best_t_alive=best["t_alive"],
               best_alive_s=best["t_alive"] * 0.01,
               wall=round(time.time() - t0, 1))
    history.append(rec)
    print(json.dumps(rec), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez(args.out, params=best["params"],
             fitness=best["fitness"], t_alive=best["t_alive"],
             mu=mu, sigma=sigma)
  with open(args.out.replace(".npz", "_history.json"), "w") as f:
    json.dump(history, f, indent=1)
  print("saved", args.out, "best fitness", best["fitness"],
        "alive", best["t_alive"] * 0.01, "s")
  return {"best": best, "history": history}


if __name__ == "__main__":
  main()

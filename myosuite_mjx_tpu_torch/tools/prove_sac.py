"""SAC proof run: train a task from scratch with SAC and measure success.

Counterpart of the JAX repository's ``tools/prove_sac.py``: the same
recipe (32 envs, 8 updates per env step, learning_starts 5000, SB3's
other defaults), a deterministic tanh(mean) evaluation every
``--eval-every-steps`` env steps (32 fresh episodes of the task's horizon
from a fixed seed; an episode succeeds when solved on more than 5 steps),
and the same JSON of the curve. The port adds ``--out``, the directory the
JSON goes to (default ``train_artifacts/sac_proof``); a file already under
``train_artifacts/`` is never overwritten. The default task is a fixture
id (``envs/myobase.py``): MyoSuite's own ids wait for its asset tree.

Usage:
  python -m myosuite_mjx_tpu_torch.tools.prove_sac [--env hand23PoseFixed-v0]
      [--total-steps N] [--out DIR] [--cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
ARTIFACTS = os.path.join(ROOT, "train_artifacts")
EVAL_SEED = 123


def build_parser() -> argparse.ArgumentParser:
  ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  ap.add_argument("--env", default="hand23PoseFixed-v0")
  ap.add_argument("--total-steps", type=int, default=1_500_000)
  ap.add_argument("--seed", type=int, default=0)
  ap.add_argument("--eval-every-steps", type=int, default=100_000)
  ap.add_argument("--config", default='{"num_envs": 32, '
                  '"updates_per_step": 8, "learning_starts": 5000}')
  ap.add_argument("--cpu", action="store_true",
                  help="train on the CPU (default: the card)")
  ap.add_argument("--out", default=os.path.join(ARTIFACTS, "sac_proof"),
                  help="directory of the <env>.json curve")
  return ap


@torch.no_grad()
def eval_policy(sac, ts, episodes: int = 32) -> dict:
  """Deterministic tanh(mean) rollouts of ``episodes`` fresh episodes for
  the task's horizon (no autoreset), from the same seed every time."""
  env, device = sac.env, sac.device
  g = torch.Generator(device=device).manual_seed(EVAL_SEED)
  st = env.reset(episodes, device, g)
  cnt = torch.zeros(episodes, dtype=sac.dtype, device=device)
  score = torch.zeros_like(cnt)
  for _ in range(int(env.horizon)):
    mean, _ = ts.actor_params(st.obs)
    st = env.step(st, torch.tanh(mean), g)
    cnt = cnt + st.info["solved"].to(sac.dtype)
    score = score + st.info["rwd_dense"]
  return dict(eval_success=float((cnt > 5).to(sac.dtype).mean()),
              eval_solved_frac=float(cnt.mean()) / int(env.horizon),
              eval_score=float(score.mean()))


def _refuses_overwrite(path: str) -> bool:
  inside = os.path.commonpath([os.path.abspath(path), ARTIFACTS]) == ARTIFACTS
  return inside and os.path.exists(path)


def main(argv=None) -> dict:
  args = build_parser().parse_args(argv)
  out = os.path.join(args.out, f"{args.env}.json")
  if _refuses_overwrite(out):
    raise SystemExit(f"{out} exists under train_artifacts/; pass another "
                     f"--out")

  from myosuite_mjx_tpu_torch import envs
  from myosuite_mjx_tpu_torch.train.common import metrics_to_host
  from myosuite_mjx_tpu_torch.train.sac import SAC, SACConfig

  device = "cpu" if args.cpu else "cuda"
  env = envs.make(args.env)
  overrides = json.loads(args.config)
  if "hidden" in overrides:
    overrides["hidden"] = tuple(overrides["hidden"])
  sac = SAC(env, SACConfig(**overrides), device)
  generator = torch.Generator(device=sac.device).manual_seed(args.seed)
  ts = sac.init(generator=generator)
  per_iter = sac.cfg.num_envs
  iters = args.total_steps // per_iter
  eval_every = max(1, args.eval_every_steps // per_iter)
  history = []
  t0 = time.time()
  for it in range(iters):
    ts, m = sac.train_step(ts, generator)
    if (it + 1) % eval_every == 0 or it == iters - 1:
      ev = eval_policy(sac, ts)
      rec = {"env_steps": (it + 1) * per_iter,
             "wall": round(time.time() - t0, 1),
             **{k: round(v, 5) for k, v in metrics_to_host(m).items()},
             **ev}
      history.append(rec)
      print(json.dumps(rec), flush=True)

  os.makedirs(args.out, exist_ok=True)
  result = {"env": args.env, "seed": args.seed, "config": overrides,
            "history": history}
  with open(out, "w") as f:
    json.dump(result, f, indent=1)
  best = max((h["eval_success"] for h in history), default=0.0)
  print(f"saved {out}; best eval_success={best}")
  return result


if __name__ == "__main__":
  main()

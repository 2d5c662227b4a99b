"""Train a task to solve and check the policy into the zoo.

Counterpart of the repository's ``tools/train_zoo_baseline.py``: trains
PPO or NPG on a task id, then writes ``<zoo>/<env_id>.pkl`` through
``train/zoo.py`` (``save_snapshot``, or ``save_npg_snapshot``'s
policy-mlp-v1 for NPG) and, next to it, ``<env_id>_metrics.json`` with
the learning curve that produced the snapshot. The zoo directory is
``train/zoo.ZOO_DIR`` unless ``--zoo-dir`` says otherwise.

  python -m myosuite_mjx_tpu_torch.tools.train_zoo_baseline \\
      --env hand23PoseFixed-v0 --algo npg [--total-steps 2000000] \\
      [--config '{"num_envs": 512}'] [--device cpu] [--zoo-dir DIR]
"""
from __future__ import annotations

import argparse
import json
import os

from myosuite_mjx_tpu_torch import envs
from myosuite_mjx_tpu_torch.train import npg, ppo, zoo


def build_parser() -> argparse.ArgumentParser:
  ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  ap.add_argument("--env", default="hand23PoseFixed-v0")
  ap.add_argument("--algo", default="ppo", choices=("ppo", "npg"))
  ap.add_argument("--total-steps", type=int, default=2_000_000)
  ap.add_argument("--seed", type=int, default=0)
  ap.add_argument("--eval-every", type=int, default=50)
  ap.add_argument("--config", default="{}",
                  help="JSON dict of PPOConfig/NPGConfig overrides, e.g. "
                       "'{\"min_log_std\": -1.0, \"num_envs\": 1024}'")
  ap.add_argument("--device", default="cuda",
                  help="torch device to train on (default: the card)")
  ap.add_argument("--zoo-dir", default=None,
                  help="where the snapshot goes (default: the zoo)")
  return ap


def main(argv=None) -> str:
  """Train and save as the flags say; returns the snapshot's path."""
  args = build_parser().parse_args(argv)
  env = envs.make(args.env)
  overrides = json.loads(args.config)
  for k in ("hidden", "vf_hidden"):
    if k in overrides:
      overrides[k] = tuple(overrides[k])
  if args.algo == "npg":
    learner = npg.NPG(env, npg.NPGConfig(**overrides), args.device)
  else:
    learner = ppo.PPO(env, ppo.PPOConfig(**overrides), args.device)

  def progress(it, m):
    if (it + 1) % 10 == 0 or "eval_solved_frac" in m:
      print(json.dumps({"iter": it + 1,
                        **{k: round(float(v), 5) for k, v in m.items()}}),
            flush=True)

  ts, history = learner.train(total_env_steps=args.total_steps,
                              seed=args.seed, eval_every=args.eval_every,
                              progress=progress)
  evals = [m["eval_solved_frac"] for m in history if "eval_solved_frac" in m]
  succ = [m["eval_success"] for m in history if "eval_success" in m]
  print(f"final eval_solved_frac: {evals[-1] if evals else None} "
        f"eval_success: {succ[-1] if succ else None}")

  path = os.path.join(args.zoo_dir or zoo.ZOO_DIR, f"{args.env}.pkl")
  if args.algo == "npg":
    zoo.save_npg_snapshot(path, learner, ts, env_id=args.env)
  else:
    zoo.save_snapshot(path, learner, ts, env_id=args.env)
  with open(path[:-4] + "_metrics.json", "w") as f:
    json.dump({"env": args.env, "seed": args.seed,
               "total_steps": args.total_steps,
               "history": [{k: float(v) for k, v in m.items()}
                           for m in history]}, f, indent=1)
  print(f"saved zoo baseline to {path}")
  return path


if __name__ == "__main__":
  main()

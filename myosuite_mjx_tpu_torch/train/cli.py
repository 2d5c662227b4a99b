"""Training CLI: pick a task id, an algorithm and its settings, train on one
device, checkpoint periodically, and resume.

Counterpart of ``myosuite_mjx_tpu/train/cli.py``, with the same flags and
defaults, plus ``--device`` (the card unless the caller asks for the CPU).
What differs:

- draws come from a ``torch.Generator`` seeded with ``--seed`` (and a
  second one for evaluation), which lives outside the learner's state, so
  every checkpoint carries both generators' states: a resumed run draws
  what the uninterrupted run would have drawn;
- precision is pinned once, when the env is built (``envs/base.py``), and
  there is no compile cache (PyTorch runs eagerly);
- ``--mesh data`` runs NPG or PPO data-parallel over ``torch.distributed``
  (``parallel/mesh.py``): in one process, or in one process per card (or
  per CPU worker, with ``--device cpu`` on ``gloo``) under ``torchrun``.
  Each process steps num_envs / world envs; rank 0 prints and writes the
  metrics, and each process checkpoints its own envs (``.rank<r>`` after
  the name on ranks above 0).

Usage:
  python -m myosuite_mjx_tpu_torch.train.cli --env hand23PoseFixed-v0 \\
      --algo npg --total-steps 512000 --num-envs 512 \\
      --checkpoint-dir /tmp/ckpt --checkpoint-every 5
  python -m myosuite_mjx_tpu_torch.train.cli --env hand11ReachRandom-v0 \\
      --algo sac --total-steps 3200 --device cpu
  python -m myosuite_mjx_tpu_torch.train.cli ... \\
      --resume /tmp/ckpt/iter_0000005
  torchrun --nproc_per_node=2 -m myosuite_mjx_tpu_torch.train.cli \\
      --env hand11PoseFixed-v0 --algo npg --num-envs 8 --device cpu \\
      --mesh data
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch


def build_parser() -> argparse.ArgumentParser:
  ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  ap.add_argument("--env", required=True, help="registered task ID")
  ap.add_argument("--algo", default="ppo", choices=("ppo", "npg", "sac"))
  ap.add_argument("--total-steps", type=int, default=1_000_000)
  ap.add_argument("--seed", type=int, default=0)
  ap.add_argument("--num-envs", type=int, default=None,
                  help="override the algorithm default")
  ap.add_argument("--learning-rate", type=float, default=None)
  ap.add_argument("--hidden", type=str, default=None,
                  help="comma-separated layer widths, e.g. 256,128")
  ap.add_argument("--mesh", default=None, choices=(None, "data"),
                  help="shard the envs of ppo or npg over the processes "
                       "of a torch.distributed group (torchrun's, or this "
                       "process alone)")
  ap.add_argument("--checkpoint-dir", default=None)
  ap.add_argument("--checkpoint-every", type=int, default=100,
                  help="iterations between checkpoints")
  ap.add_argument("--resume", default=None,
                  help="checkpoint path to resume from")
  ap.add_argument("--log-every", type=int, default=10)
  ap.add_argument("--eval-every", type=int, default=0,
                  help="iterations between deterministic-policy evals "
                       "(ppo and npg; 0 disables)")
  ap.add_argument("--metrics-out", default=None,
                  help="write the full metrics history as JSON here")
  ap.add_argument("--logdir", default=None,
                  help="per-iteration metrics sink: <logdir>/metrics.jsonl "
                       "+ tensorboard events")
  ap.add_argument("--device", default="cuda",
                  help="torch device to train on (default: the card)")
  return ap


def make_learner(args, env):
  """(learner, env steps per iteration) for ``args.algo``."""
  overrides = {}
  if args.num_envs is not None:
    overrides["num_envs"] = args.num_envs
  if args.learning_rate is not None:
    overrides["learning_rate"] = args.learning_rate
  if args.hidden is not None:
    overrides["hidden"] = tuple(int(x) for x in args.hidden.split(","))
  if args.algo == "ppo":
    from myosuite_mjx_tpu_torch.train import ppo
    cfg = ppo.PPOConfig(**overrides)
    return (ppo.PPO(env, cfg, args.device),
            cfg.unroll_length * cfg.num_envs)
  if args.algo == "npg":
    from myosuite_mjx_tpu_torch.train import npg
    cfg = npg.NPGConfig(**overrides)
    return npg.NPG(env, cfg, args.device), cfg.num_envs * int(env.horizon)
  from myosuite_mjx_tpu_torch.train import sac
  cfg = sac.SACConfig(**overrides)
  return sac.SAC(env, cfg, args.device), cfg.num_envs


def main(argv=None):
  """Train as the flags say; returns the final learner state."""
  args = build_parser().parse_args(argv)
  lead, rank_suffix = True, ""
  if args.mesh == "data":
    if args.algo == "sac":
      raise SystemExit("--mesh data shards --algo ppo and npg")
    from myosuite_mjx_tpu_torch.parallel import mesh as pmesh
    if args.device == "cuda" and "LOCAL_RANK" in os.environ:
      # one card per process
      args.device = f"cuda:{os.environ['LOCAL_RANK']}"
      torch.cuda.set_device(args.device)
    pmesh.init_distributed(device=args.device)
    mesh = pmesh.data_mesh()
    lead = mesh.rank == 0
    rank_suffix = f".rank{mesh.rank}" if mesh.rank else ""

  from myosuite_mjx_tpu_torch import envs
  from myosuite_mjx_tpu_torch.train import checkpoint
  from myosuite_mjx_tpu_torch.train import metrics as metrics_mod
  from myosuite_mjx_tpu_torch.train.common import metrics_to_host

  env = envs.make(args.env)
  learner, per_iter = make_learner(args, env)
  if args.mesh == "data":
    sharded = pmesh.ShardedPPO if args.algo == "ppo" else pmesh.ShardedNPG
    learner = sharded(learner, mesh, seed=args.seed)
  device = learner.device
  # the learners' own train() seeds its generators the same way
  generator = torch.Generator(device=device).manual_seed(args.seed)
  eval_gen = torch.Generator(device=device).manual_seed(args.seed ^ 0x45564C)
  run = {"state": learner.init(generator=generator), "generator": generator,
         "eval_generator": eval_gen}
  start_iter = 0
  if args.resume:
    run = checkpoint.restore(args.resume + rank_suffix, run)
    # the iteration count follows from the restored env-step counter, so
    # iteration numbers, env_steps and checkpoint names continue
    start_iter = int(run["state"].steps) // per_iter
    if lead:
      print(f"resumed from {args.resume} at iter {start_iter}", flush=True)

  eval_fn = None
  if args.eval_every and args.algo in ("ppo", "npg"):
    eval_fn = lambda ts: learner.eval_step(ts, generator=eval_gen)
  iters = max(1, args.total_steps // per_iter)
  t0 = time.time()
  last_t, last_steps = t0, start_iter * per_iter
  history = []
  writer = (metrics_mod.MetricsWriter(
      args.logdir,
      truncate_after=start_iter * per_iter if args.resume else None)
      if args.logdir and lead else None)
  for it in range(start_iter, iters):
    ts, metrics = learner.train_step(run["state"], generator)
    run["state"] = ts
    if it == start_iter:
      # the rate window starts after the first iteration, whose one-time
      # costs (the kernel's build and load, allocator warm-up) it leaves out
      if device.type == "cuda":
        torch.cuda.synchronize(device)
      last_t, last_steps = time.time(), (it + 1) * per_iter
    if eval_fn is not None and ((it + 1) % args.eval_every == 0
                                or it == iters - 1):
      metrics = {**metrics, **eval_fn(ts)}
    log_now = (it + 1) % args.log_every == 0 or it == iters - 1
    if log_now or writer is not None:
      metrics = metrics_to_host(metrics)
      # divergence guard: emergency-checkpoint, then abort loudly
      try:
        metrics_mod.check_finite(metrics, where=f"iter {it + 1}")
      except metrics_mod.DivergenceError:
        if args.checkpoint_dir:
          checkpoint.save(os.path.join(
              args.checkpoint_dir,
              f"diverged_iter_{it + 1:07d}{rank_suffix}"), run)
        raise
      now = time.time()
      steps_now = (it + 1) * per_iter
      # the rate over the logging window, not since the start
      rate = (steps_now - last_steps) / max(now - last_t, 1e-9)
      last_t, last_steps = now, steps_now
      rec = {
          "iter": it + 1,
          "env_steps": steps_now,
          "wall_s": round(now - t0, 2),
          "steps_per_s": round(rate, 1),
          **{k: round(v, 5) for k, v in metrics.items()},
      }
      if writer is not None:
        writer.write(rec["env_steps"], rec)
      if log_now:
        history.append(rec)
        if lead:
          print(json.dumps(rec), flush=True)
    if args.checkpoint_dir and ((it + 1) % args.checkpoint_every == 0
                                or it == iters - 1):
      checkpoint.save(os.path.join(args.checkpoint_dir,
                                   f"iter_{it + 1:07d}{rank_suffix}"), run)
  if writer is not None:
    writer.close()
  if args.metrics_out and lead:
    with open(args.metrics_out, "w") as f:
      json.dump({"args": vars(args), "history": history}, f, indent=1)
  return run["state"]


if __name__ == "__main__":
  main()

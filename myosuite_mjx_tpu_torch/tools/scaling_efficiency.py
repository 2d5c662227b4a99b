"""Data-parallel parity and scaling over ``torch.distributed``.

Counterpart of the repository's ``tools/scaling_efficiency.py``. For each
world size it starts that many processes, joined by a process group
(``parallel/mesh.py``), and checks that one sharded train step of PPO
and of NPG equals the single-process step from the same seed: every
parameter and every metric, relative to the largest entry (float64 by
default, so the residual is the order of the reductions). Then it times
``--iters`` sharded steps per world size.

``--device cuda`` (the default) puts one process on each card, joined
by NCCL, so a world size may not exceed the cards there are.
``--device cpu`` runs the processes on this host's CPU, joined by gloo;
they share its cores and memory bandwidth, so their env-steps/s are the
program's overhead on the CPU, not a scaling number of any device. The
table goes to stdout and names the device of its timing column.

  python -m myosuite_mjx_tpu_torch.tools.scaling_efficiency \\
      [--env hand11PoseFixed-v0] [--worlds 1,2,4] [--iters 2] \\
      [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import os
import socket
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from myosuite_mjx_tpu_torch import envs
from myosuite_mjx_tpu_torch.parallel import mesh as pmesh
from myosuite_mjx_tpu_torch.train import npg as npg_mod
from myosuite_mjx_tpu_torch.train import ppo as ppo_mod

# one optimizer update per PPO step, as the JAX tool's parity config;
# data_groups 4 splits over 1, 2 and 4 processes
PARITY_CONFIGS = {
    "ppo": dict(num_envs=8, unroll_length=4, num_minibatches=1,
                update_epochs=1, data_groups=4),
    "npg": dict(num_envs=8, vf_batch_size=8),
}
ENV_KWARGS = dict(frame_skip=2, horizon=4)


def make_learner(spec: dict, device=None):
  """The single-process learner of ``spec`` (env id and kwargs, dtype
  name, algo, config overrides and device) on ``device``, by default the
  spec's."""
  env = envs.make(spec["env"], dtype=getattr(torch, spec["dtype"]),
                  **spec["env_kwargs"])
  device = device or spec["device"]
  if spec["algo"] == "ppo":
    return ppo_mod.PPO(env, ppo_mod.PPOConfig(**spec["config"]), device)
  return npg_mod.NPG(env, npg_mod.NPGConfig(**spec["config"]), device)


def flat_params(ts) -> torch.Tensor:
  """Every learned parameter of a PPO or NPG state, flattened."""
  nets = [ts.params] + ([ts.vf_params] if hasattr(ts, "vf_params") else [])
  return torch.cat([p.detach().reshape(-1) for n in nets
                    for p in n.parameters()])


def step_once(learner, seed: int = 0):
  """(state after one train step from ``seed``, metrics as floats)."""
  g = torch.Generator(device=learner.device).manual_seed(seed)
  ts, metrics = learner.train_step(learner.init(generator=g), g)
  return ts, {k: float(v) for k, v in metrics.items()}


def _rank_device(spec_device: str, rank: int) -> torch.device:
  """One card per process on CUDA; the CPU otherwise."""
  if torch.device(spec_device).type == "cuda":
    torch.cuda.set_device(rank)
    return torch.device("cuda", rank)
  torch.set_num_threads(1)
  return torch.device("cpu")


def _sync(device: torch.device) -> None:
  dist.barrier()
  if device.type == "cuda":
    torch.cuda.synchronize(device)


def _rank_main(rank: int, world: int, address: str, specs: list,
               iters: int, out_dir: str) -> None:
  device = _rank_device(specs[0]["device"], rank)
  pmesh.init_distributed(address, world, rank, device=device)
  try:
    out = []
    for spec in specs:
      learner = make_learner(spec, device)
      sharded = (pmesh.ShardedPPO if spec["algo"] == "ppo"
                 else pmesh.ShardedNPG)(learner)
      ts, metrics = step_once(sharded)
      params = flat_params(ts).cpu()     # the nets move on in place
      g = torch.Generator(device=device).manual_seed(1)
      _sync(device)
      t0 = time.perf_counter()
      for _ in range(iters):
        ts, _ = sharded.train_step(ts, g)
      _sync(device)
      out.append(dict(params=params, metrics=metrics,
                      seconds=(time.perf_counter() - t0) / max(iters, 1)))
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
  finally:
    dist.destroy_process_group()


def free_address() -> str:
  with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def run_sharded(world: int, specs: list, iters: int = 0) -> list:
  """Per rank, per spec: the params after one sharded step from seed 0,
  its metrics and the seconds of each of ``iters`` later steps, from
  ``world`` processes (gloo on the CPU, NCCL on the cards)."""
  with tempfile.TemporaryDirectory() as out_dir:
    mp.spawn(_rank_main, args=(world, free_address(), specs, iters, out_dir),
             nprocs=world, join=True)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"))
            for r in range(world)]


def relative_errors(ref_ts, ref_metrics: dict, params: torch.Tensor,
                    metrics: dict) -> dict:
  """Largest parameter difference relative to the largest parameter, and
  each metric's relative to the metric (or to 1e-6, for one near 0)."""
  ref = flat_params(ref_ts).cpu()
  out = {"params": float((params - ref).abs().max() / ref.abs().max())}
  for k, v in ref_metrics.items():
    out[k] = abs(metrics[k] - v) / max(abs(v), 1e-6)
  return out


def specs_for(env_id: str, algos, dtype: str = "float64",
              configs: dict = PARITY_CONFIGS, device: str = "cuda") -> list:
  """The specs ``make_learner`` reads, one per algo."""
  return [dict(env=env_id, env_kwargs=dict(ENV_KWARGS), dtype=dtype, algo=a,
               config=dict(configs[a]), device=device) for a in algos]


def build_parser() -> argparse.ArgumentParser:
  ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  ap.add_argument("--env", default="hand11PoseFixed-v0")
  ap.add_argument("--algos", default="ppo,npg")
  ap.add_argument("--worlds", default="1,2,4")
  ap.add_argument("--iters", type=int, default=2)
  ap.add_argument("--dtype", default="float64")
  ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                  help="cuda: one process per card over NCCL; cpu: gloo "
                  "processes on this host")
  ap.add_argument("--bound", type=float, default=1e-9,
                  help="largest relative difference allowed")
  return ap


def main(argv=None) -> list:
  """Check and time as the flags say; returns the table's rows. Raises
  if a sharded step leaves the bound."""
  args = build_parser().parse_args(argv)
  worlds = [int(w) for w in args.worlds.split(",")]
  if args.device == "cuda":
    cards = torch.cuda.device_count()
    if max(worlds) > cards:
      raise SystemExit(
          f"--worlds {args.worlds} needs {max(worlds)} cards, one per "
          f"process, and this host has {cards}; pass smaller world sizes, "
          "or --device cpu for gloo processes on the CPU")
  specs = specs_for(args.env, args.algos.split(","), args.dtype,
                    device=args.device)
  refs = []
  for spec in specs:
    learner = make_learner(spec)
    refs.append((*step_once(learner), learner))
  rows = []
  where = ("CPU, gloo" if args.device == "cpu"
           else f"{torch.cuda.get_device_name(0)}, NCCL")
  print(f"| algo | processes | env-steps/s ({where}) | params rel. err | "
        "worst metric rel. err |")
  print("|---|---|---|---|---|")
  for world in worlds:
    ranks = run_sharded(world, specs, args.iters)
    for i, (spec, (ts, metrics, learner)) in enumerate(zip(specs, refs)):
      errs = [relative_errors(ts, metrics, r[i]["params"], r[i]["metrics"])
              for r in ranks]
      worst = {k: max(e[k] for e in errs) for k in errs[0]}
      cfg = learner.cfg
      per_iter = cfg.num_envs * (cfg.unroll_length if spec["algo"] == "ppo"
                                 else learner.horizon)
      sps = per_iter / max(r[i]["seconds"] for r in ranks)
      metric_err = max(v for k, v in worst.items() if k != "params")
      rows.append(dict(algo=spec["algo"], world=world, env_steps_per_s=sps,
                       **{f"err_{k}": v for k, v in worst.items()}))
      print(f"| {spec['algo']} | {world} | {sps:.1f} | "
            f"{worst['params']:.2e} | {metric_err:.2e} |", flush=True)
      if max(worst.values()) > args.bound:
        raise AssertionError(
            f"{spec['algo']} at {world} processes: {worst} past "
            f"{args.bound:g}")
  return rows


if __name__ == "__main__":
  main()

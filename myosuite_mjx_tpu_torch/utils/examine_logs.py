"""examine_logs CLI: record rollouts into a trace, or play a trace back.

Counterpart of ``myosuite_mjx_tpu/utils/examine_logs.py``: ``record``
steps fresh episodes with uniform random actions into a ``Trace``;
``playback`` restores each trial's logged first state through the env's
``reset_to``, replays its logged actions and reports the return, how far
the replayed observations and the final qpos are from the log. Trials run
as one batch, on the card unless ``--device cpu``. The JAX command's
``render`` mode is left out: it goes through ``utils/render.py``, which
needs MuJoCo's renderer.

Usage:
  python -m myosuite_mjx_tpu_torch.utils.examine_logs -e hand23PoseFixed-v0 \\
      -m record --horizon 50 -o /tmp -n rollout
  python -m myosuite_mjx_tpu_torch.utils.examine_logs -e hand23PoseFixed-v0 \\
      -m playback -p /tmp/rollout.h5
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from myosuite_mjx_tpu_torch.logger.trace import Trace


def record(env, horizon: int, num_repeat: int, seed: int,
           device="cuda") -> Trace:
  """``num_repeat`` episodes of ``horizon`` steps (``env.step``, no
  autoreset) as one batch; env i is group ``Trial{i}``."""
  trace = Trace("Rollouts")
  g = torch.Generator(device=device).manual_seed(seed)
  st = env.reset(num_repeat, device, g)
  for _ in range(horizon):
    a = 2.0 * torch.rand((num_repeat, env.action_dim), generator=g,
                         dtype=env.dtype, device=device) - 1.0
    nxt = env.step(st, a, g)
    rec = {k: v.detach().cpu().numpy() for k, v in dict(
        time=st.data.time, actions=a, observations=st.obs,
        rewards=nxt.reward, done=nxt.done, qpos=st.data.qpos,
        qvel=st.data.qvel).items()}
    for ep in range(num_repeat):
      trace.append_datums(f"Trial{ep}", **{k: v[ep] for k, v in rec.items()})
    st = nxt
  trace.stack()
  return trace


def playback(env, trace: Trace, seed: int, device="cuda") -> dict:
  """Replay every trial's logged actions from its logged first state, all
  trials as one batch. Per trial: the return, the largest difference of a
  replayed observation from the logged one (``obs_err``) and the distance
  of the final replayed qpos from the log (``qpos_drift``)."""
  groups = list(trace.trace)
  logs = {k: np.stack([np.asarray(trace.trace[g][k]) for g in groups], 1)
          for k in ("qpos", "qvel", "actions", "observations")}
  t = lambda x: torch.as_tensor(x, dtype=env.dtype, device=device)
  g = torch.Generator(device=device).manual_seed(seed)
  st = env.reset_to(t(logs["qpos"][0]), t(logs["qvel"][0]), g)
  ret = np.zeros(len(groups))
  obs_err = np.abs(st.obs.cpu().numpy() - logs["observations"][0]).max(1)
  # logged qpos[t] is the state before action t: replaying actions[:t]
  # lands on it, so the last comparable state is after actions[:-1]
  steps = logs["actions"].shape[0]
  for i in range(steps):
    st = env.step(st, t(logs["actions"][i]), g)
    ret += st.reward.cpu().numpy()
    if i + 1 < steps:
      obs = st.obs.cpu().numpy()
      obs_err = np.maximum(
          obs_err, np.abs(obs - logs["observations"][i + 1]).max(1))
    if i + 2 == steps:
      drift = np.linalg.norm(st.data.qpos.cpu().numpy() - logs["qpos"][-1],
                             axis=1)
  if steps == 1:
    drift = np.zeros(len(groups))
  results = {}
  for k, name in enumerate(groups):
    results[name] = dict(ret=float(ret[k]), qpos_drift=float(drift[k]),
                         obs_err=float(obs_err[k]))
    print(f"{name}: return={ret[k]:.3f} final qpos drift vs log="
          f"{drift[k]:.2e} obs err vs log={obs_err[k]:.2e}")
  return results


def main(argv=None):
  ap = argparse.ArgumentParser()
  ap.add_argument("--env_name", "-e", required=True)
  ap.add_argument("--mode", "-m", default="playback",
                  choices=("record", "playback"))
  ap.add_argument("--rollout_path", "-p", default=None)
  ap.add_argument("--horizon", type=int, default=50)
  ap.add_argument("--seed", "-s", type=int, default=0)
  ap.add_argument("--num_repeat", type=int, default=1)
  ap.add_argument("--output_dir", "-o", default="/tmp")
  ap.add_argument("--output_name", "-n", default="rollout")
  ap.add_argument("--output_format", "-f", default="h5",
                  choices=("h5", "pickle"))
  ap.add_argument("--device", default="cuda")
  args = ap.parse_args(argv)

  from myosuite_mjx_tpu_torch import envs
  env = envs.make(args.env_name)

  if args.mode == "record":
    trace = record(env, args.horizon, args.num_repeat, args.seed, args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    ext = "h5" if args.output_format == "h5" else "pkl"
    out = os.path.join(args.output_dir, f"{args.output_name}.{ext}")
    trace.save(out)
    print(f"recorded {args.num_repeat} x {args.horizon} steps -> {out}")
    return out
  if not args.rollout_path:
    ap.error(f"--rollout_path is required for {args.mode}")
  return playback(env, Trace.load(args.rollout_path), args.seed, args.device)


if __name__ == "__main__":
  main()

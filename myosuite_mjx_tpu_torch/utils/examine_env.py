"""examine_env CLI: roll out a policy on a task and save the rollout.

Counterpart of ``myosuite_mjx_tpu/utils/examine_env.py``: a random or a
saved-params policy over N episodes into a ``Trace`` (h5 or pickle). The
port runs the N episodes as one batch of N envs on the card (``--device``
for another), each recorded until its first ``done`` or the horizon. The
random policy draws one action per env of ``env.action_dim`` (the JAX one
draws ``model.nu``, the same on every task but RunTrack). The JAX
command's ``--render`` path is left out: it goes through
``utils/render.py``, which needs MuJoCo's renderer.

Usage:
  python -m myosuite_mjx_tpu_torch.utils.examine_env \\
      --env_name hand23PoseFixed-v0 --num_episodes 3 --output_dir /tmp/rollouts
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
import torch

from myosuite_mjx_tpu_torch.logger.trace import Trace


def random_policy(env, generator: torch.Generator):
  """act(obs [B, obs_dim]) -> uniform actions in [-1, 1], [B, action_dim],
  drawn from ``generator`` (on the obs's device)."""
  def act(obs: torch.Tensor) -> torch.Tensor:
    u = torch.rand((obs.shape[0], env.action_dim), generator=generator,
                   dtype=obs.dtype, device=obs.device)
    return 2.0 * u - 1.0
  return act


def params_policy(env, path: str, device="cuda"):
  """Policy from a zoo snapshot (``train/zoo.py``, with its obs-norm
  statistics) or a bare pickled flax ``ActorCritic`` params tree (the
  mean, clipped to [-1, 1]). Unpickles ``path``: load only trusted files."""
  from myosuite_mjx_tpu_torch.train.common import load_flax_params
  from myosuite_mjx_tpu_torch.train.ppo import ActorCritic
  with open(path, "rb") as f:
    params = pickle.load(f)
  if isinstance(params, dict) and "params" in params and "format" in params:
    from myosuite_mjx_tpu_torch.train.zoo import Policy
    return Policy(params, device, env.dtype).act
  tree = params["params"]
  dense = sorted((k for k in tree if k.startswith("Dense_")),
                 key=lambda k: int(k.split("_")[1]))
  depth = len(dense) // 2 - 1   # the policy's and the value's hidden layers
  hidden = tuple(np.asarray(tree[k]["kernel"]).shape[1]
                 for k in dense[:depth])
  obs_dim = np.asarray(tree["Dense_0"]["kernel"]).shape[0]
  act_dim = np.asarray(tree[dense[depth]]["kernel"]).shape[1]
  net = ActorCritic(obs_dim, act_dim, hidden, dtype=env.dtype, device=device)
  load_flax_params(net, params)

  @torch.no_grad()
  def act(obs: torch.Tensor) -> torch.Tensor:
    mean, _, _ = net(obs.to(env.dtype))
    return torch.clamp(mean, -1.0, 1.0)
  return act


def rollout(env, policy, num_episodes: int, seed: int, device="cuda"):
  """``num_episodes`` episodes as one batch on ``device``; env i is group
  ``Trial{i}`` of the returned ``Trace``, recorded until its first done."""
  trace = Trace("rollout")
  g = torch.Generator(device=device).manual_seed(seed)
  st = env.reset(num_episodes, device, g)
  live = np.ones(num_episodes, bool)
  for _ in range(env.horizon):
    a = policy(st.obs)
    nxt = env.step(st, a, g)
    rec = {k: v.detach().cpu().numpy() for k, v in dict(
        time=st.data.time, observations=st.obs, actions=a,
        rewards=nxt.reward, done=nxt.done, qpos=st.data.qpos,
        qvel=st.data.qvel).items()}
    for ep in np.flatnonzero(live):
      trace.append_datums(f"Trial{ep}", **{k: v[ep] for k, v in rec.items()})
    live &= ~rec["done"]
    st = nxt
    if not live.any():
      break
  trace.stack()
  return trace


def main(argv=None) -> str:
  ap = argparse.ArgumentParser()
  ap.add_argument("--env_name", "-e", required=True)
  ap.add_argument("--policy_path", "-p", default=None)
  ap.add_argument("--num_episodes", "-n", type=int, default=2)
  ap.add_argument("--seed", "-s", type=int, default=0)
  ap.add_argument("--output_dir", "-o", default="/tmp")
  ap.add_argument("--output_format", "-f", default="h5",
                  choices=("h5", "pickle"))
  ap.add_argument("--device", default="cuda")
  args = ap.parse_args(argv)

  from myosuite_mjx_tpu_torch import envs
  env = envs.make(args.env_name)
  policy = (params_policy(env, args.policy_path, args.device)
            if args.policy_path else
            random_policy(env, torch.Generator(device=args.device)
                          .manual_seed(args.seed + 1)))
  trace = rollout(env, policy, args.num_episodes, args.seed, args.device)
  os.makedirs(args.output_dir, exist_ok=True)
  ext = "h5" if args.output_format == "h5" else "pkl"
  out = os.path.join(args.output_dir, f"{args.env_name}_rollout.{ext}")
  trace.save(out)
  print(f"saved {args.num_episodes} episodes to {out}")
  print(trace)
  return out


if __name__ == "__main__":
  main()

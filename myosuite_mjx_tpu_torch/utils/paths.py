"""Offline path (rollout dataset) evaluation.

Counterpart of ``myosuite_mjx_tpu/utils/paths.py``: ``obs_layout``,
``obsvec2obsdict``, ``compute_path_rewards``, ``truncate_paths``,
``evaluate_success`` and ``paths2dataset`` over the port's batched envs. A
path is a dict with (at least) ``observations`` [T, obs_dim] (or
[N, T, obs_dim]), ``actions`` and optionally ``env_infos``, the layout
``logger/trace.py`` holds. Paths stay numpy on the host; the rewards are
scored on the device the caller names (the card unless it asks for the
CPU).
"""
from __future__ import annotations

import types

import numpy as np
import torch


def obs_layout(env, device="cuda") -> dict:
  """Key -> (start, stop) slice of the env's obs vector, read off one
  B = 1 reset on ``device`` (the JAX module traces the reset's shapes)."""
  st = env.reset(1, device)
  od = env.get_obs_dict(st.data, st.aux)
  layout = {}
  off = 0
  for k in env.obs_keys:
    n = int(np.prod(od[k].shape[1:]))
    layout[k] = (off, off + n)
    off += n
  return layout


def obsvec2obsdict(env, obsvec, device="cuda") -> dict:
  """Split a [..., obs_dim] array (numpy or tensor) by the env's obs codec
  (``obs_layout`` on ``device``)."""
  return {k: obsvec[..., a:b]
          for k, (a, b) in obs_layout(env, device).items()}


def compute_path_rewards(env, paths: dict, rwd_mode: str = "dense",
                         device="cuda") -> dict:
  """Re-score offline observations with the env's reward, on ``device``.

  paths["observations"]: [num_traj, horizon, obs_dim] (or [horizon,
  obs_dim]); ``paths["aux"]``, if given, is the task state the reward
  reads (tensors or arrays, broadcast over the steps). Adds time-aligned
  paths["rewards"] and paths["done"] (numpy; the reference's shift
  done[..., :-1] = done[..., 1:] is kept so returns match).
  """
  obs = np.asarray(paths["observations"])
  lead = obs.shape[:-1]
  flat = torch.as_tensor(obs.reshape(-1, obs.shape[-1]), dtype=env.dtype,
                         device=device)
  obs_dict = obsvec2obsdict(env, flat, device)
  tvals = obs_dict.get("time", torch.zeros_like(flat[:, :1]))
  data = types.SimpleNamespace(time=tvals[..., 0])
  aux = {k: torch.as_tensor(np.asarray(v), device=device)
         for k, v in paths.get("aux", {}).items()}
  rwd = env.get_reward_dict(obs_dict, data, aux)
  if rwd_mode == "sparse":
    rewards = rwd["sparse"]
  else:
    rewards = sum(wt * rwd[key] for key, wt in env.rwd_keys_wt.items())
  rewards = rewards.detach().cpu().numpy().reshape(lead).copy()
  done = rwd["done"].detach().cpu().numpy().astype(bool).reshape(lead)
  # time-align: reward / done at index t describe the transition into t+1
  done[..., :-1] = done[..., 1:]
  rewards[..., :-1] = rewards[..., 1:]
  paths["done"] = done if done.ndim > 1 and done.shape[0] > 1 \
      else done.ravel()
  paths["rewards"] = rewards if rewards.ndim > 1 and rewards.shape[0] > 1 \
      else rewards.ravel()
  return paths


def truncate_paths(paths: list) -> list:
  """Cut each path at its first done."""
  for path in paths:
    done = np.asarray(path["done"], dtype=bool)
    if not done[-1]:
      path["terminated"] = False
    elif not done[0]:
      terminated_idx = int(np.sum(~done)) + 1
      for key in list(path.keys()):
        v = path[key]
        if isinstance(v, np.ndarray) and v.ndim >= 1 and \
            v.shape[0] >= terminated_idx + 1:
          path[key] = v[: terminated_idx + 1, ...]
      path["terminated"] = True
  return paths


def evaluate_success(paths: list, logger=None,
                     successful_steps: int = 5, horizon: int | None = None):
  """Success %% over paths: solved for more than ``successful_steps``
  steps. With a ``logger`` (``log_kv(key, value)``) it also logs the mean
  sparse and per-step dense reward."""
  num_success = 0
  for path in paths:
    solved = np.asarray(path["env_infos"]["solved"], dtype=np.float64)
    if solved.sum() > successful_steps:
      num_success += 1
  success_percentage = num_success * 100.0 / max(len(paths), 1)
  if logger is not None:
    rwd_sparse = float(np.mean(
        [np.mean(p["env_infos"]["rwd_sparse"]) for p in paths]))
    hor = horizon or max(len(p["env_infos"]["rwd_dense"]) for p in paths)
    rwd_dense = float(np.mean(
        [np.sum(p["env_infos"]["rwd_dense"]) / hor for p in paths]))
    logger.log_kv("rwd_sparse", rwd_sparse)
    logger.log_kv("rwd_dense", rwd_dense)
    logger.log_kv("success_percentage", success_percentage)
  return success_percentage


def paths2dataset(paths: list) -> dict:
  """Stack a list of equal-length paths into one batched dataset dict."""
  out = {}
  for k, v0 in paths[0].items():
    if isinstance(v0, dict):
      out[k] = {kk: np.stack([np.asarray(p[k][kk]) for p in paths])
                for kk in v0}
    elif isinstance(v0, np.ndarray) or np.isscalar(v0):
      out[k] = np.stack([np.asarray(p[k]) for p in paths])
  return out

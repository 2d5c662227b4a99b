"""Pretrained-policy zoo: self-contained policy snapshots + loader.

Counterpart of ``myosuite_mjx_tpu/train/zoo.py``, with the same pickle
formats, so the checked-in snapshots load in both packages unchanged:

- ``policy-v1``: a PPO ``ActorCritic``'s flax params tree (numpy), its
  architecture and the obs-normalization statistics it was trained under;
- ``policy-mlp-v1``: an explicit feedforward net, (W [in, out], b) layers
  with the input shift/scale/clip and output scale/shift folded in (what
  ``save_npg_snapshot`` writes, and the reference's mjrl policies).

Zoo layout: ``train_artifacts/zoo/<env_id>.pkl`` (``MYOSUITE_TPU_ZOO``
overrides the directory); ``load_baseline`` looks snapshots up by env ID.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from myosuite_mjx_tpu_torch.train.common import flax_params, load_flax_params
from myosuite_mjx_tpu_torch.train.ppo import ActorCritic

ZOO_DIR = os.environ.get(
    "MYOSUITE_TPU_ZOO",
    os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "train_artifacts", "zoo"))

_MLP = "myosuite_mjx_tpu/policy-mlp-v1"
_AC = "myosuite_mjx_tpu/policy-v1"


def _np(x: torch.Tensor) -> np.ndarray:
  return x.detach().cpu().numpy()


def save_snapshot(path: str, ppo, ts, env_id: str) -> dict:
  """Freeze a PPO TrainState into a self-contained policy snapshot."""
  snap = {
      "format": _AC,
      "env_id": env_id,
      "act_dim": int(ppo.act_dim),
      "hidden": tuple(ppo.cfg.hidden),
      "normalize_obs": bool(ppo.cfg.normalize_obs),
      "norm_clip": float(ppo.cfg.norm_clip),
      "params": flax_params(ts.params),
      "obs_mean": _np(ts.obs_norm.mean),
      "obs_var": _np(ts.obs_norm.var),
      "env_steps": int(ts.steps),
  }
  os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
  with open(path, "wb") as f:
    pickle.dump(snap, f)
  return snap


def save_npg_snapshot(path: str, npg, ts, env_id: str) -> dict:
  """Freeze an NPGState into a policy-mlp-v1 snapshot: the GaussianMLP mean
  path becomes explicit (W, b) layers and the running obs normalization
  folds into in_shift/in_scale (with the trainer's clip as in_clip)."""
  dense = flax_params(ts.params)["params"]
  names = sorted((k for k in dense if k.startswith("Dense_")),
                 key=lambda s: int(s.split("_")[1]))
  layers = [(dense[n]["kernel"], dense[n]["bias"]) for n in names]
  obs_dim = layers[0][0].shape[0]
  if npg.cfg.normalize_obs:
    in_shift = _np(ts.obs_norm.mean)
    in_scale = np.sqrt(_np(ts.obs_norm.var) + 1e-8)
  else:
    in_shift = np.zeros(obs_dim)
    in_scale = np.ones(obs_dim)
  return save_mlp_snapshot(
      path, env_id, layers, in_shift, in_scale,
      out_shift=np.zeros(layers[-1][0].shape[1]),
      out_scale=np.ones(layers[-1][0].shape[1]),
      nonlinearity="tanh", source=f"npg@{int(ts.steps)}steps",
      in_clip=float(npg.cfg.norm_clip))


def save_mlp_snapshot(path: str, env_id: str, layers: list,
                      in_shift, in_scale, out_shift, out_scale,
                      nonlinearity: str = "tanh",
                      source: str | None = None,
                      in_clip: float | None = None) -> dict:
  """Freeze a plain feedforward policy into a zoo snapshot.

  ``layers`` is a list of (W, b) with W of shape [in, out]; the forward
  pass is mjrl's FCNetwork: ``h = (obs - in_shift) / (in_scale + 1e-8)``
  (clipped to +-in_clip when given) through the hidden nonlinearities,
  then ``out * out_scale + out_shift``.
  """
  snap = {
      "format": _MLP,
      "env_id": env_id,
      "layers": [(np.asarray(w, np.float32), np.asarray(b, np.float32))
                 for w, b in layers],
      "in_shift": np.asarray(in_shift, np.float32),
      "in_scale": np.asarray(in_scale, np.float32),
      "out_shift": np.asarray(out_shift, np.float32),
      "out_scale": np.asarray(out_scale, np.float32),
      "nonlinearity": nonlinearity,
      "source": source or "",
      "in_clip": in_clip,
  }
  os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
  with open(path, "wb") as f:
    pickle.dump(snap, f)
  return snap


class Policy:
  """Deterministic inference policy from a snapshot: obs [..., obs_dim] ->
  action [..., act_dim] in [-1, 1], computed in ``dtype`` on ``device``
  (the card unless the caller asks for the CPU)."""

  def __init__(self, snap: dict, device="cuda",
               dtype: torch.dtype = torch.float32):
    self.snap = snap
    self.env_id = snap["env_id"]
    self.device = torch.device(device)
    self.dtype = dtype
    self._fmt = snap.get("format", _AC)
    t = lambda x: torch.as_tensor(np.asarray(x), device=device).to(dtype)
    # the denominators are formed in the snapshot's own dtype (float32 in
    # the zoo), as the reference does, and only then cast
    if self._fmt == _MLP:
      self._layers = [(t(w), t(b)) for w, b in snap["layers"]]
      self._in_shift = t(snap["in_shift"])
      self._in_den = t(np.asarray(snap["in_scale"]) + 1e-8)
      self._out_shift = t(snap["out_shift"])
      self._out_scale = t(snap["out_scale"])
      self._in_clip = snap.get("in_clip")
      self._nl = {"tanh": torch.tanh, "relu": torch.relu}[
          snap.get("nonlinearity", "tanh")]
      return
    params = snap["params"]
    obs_dim = np.asarray(params["params"]["Dense_0"]["kernel"]).shape[0]
    self.net = ActorCritic(obs_dim, int(snap["act_dim"]),
                           tuple(snap["hidden"]),
                           generator=torch.Generator(device=self.device),
                           dtype=dtype, device=self.device)
    load_flax_params(self.net, params)
    self._mean = t(snap["obs_mean"])
    self._std = t(np.sqrt(np.asarray(snap["obs_var"]) + 1e-8))
    self._norm = bool(snap.get("normalize_obs", False))
    self._clip = float(snap.get("norm_clip", 10.0))

  @torch.no_grad()
  def act(self, obs: torch.Tensor) -> torch.Tensor:
    obs = obs.to(device=self.device, dtype=self.dtype)
    if self._fmt == _MLP:
      x = (obs - self._in_shift) / self._in_den
      if self._in_clip is not None:
        x = x.clamp(-self._in_clip, self._in_clip)
      for w, b in self._layers[:-1]:
        x = self._nl(x @ w + b)
      w, b = self._layers[-1]
      x = (x @ w + b) * self._out_scale + self._out_shift
      return x.clamp(-1.0, 1.0)
    if self._norm:
      obs = ((obs - self._mean) / self._std).clamp(-self._clip, self._clip)
    mean, _, _ = self.net(obs)
    return mean.clamp(-1.0, 1.0)

  __call__ = act


def load_policy(path: str, device="cuda",
                dtype: torch.dtype = torch.float32) -> Policy:
  """Load a policy snapshot written by ``save_snapshot`` or
  ``save_mlp_snapshot``.

  Trust note: snapshots are pickles (matching the reference's pickle zoo,
  e.g. agents/baslines_NPG/*.pickle); unpickling executes code, so only
  load snapshots from sources you trust.
  """
  with open(path, "rb") as f:
    snap = pickle.load(f)
  if not (isinstance(snap, dict) and ("params" in snap
                                      or "layers" in snap)):
    raise ValueError(f"{path} is not a policy snapshot "
                     "(expected dict with 'params' or 'layers')")
  return Policy(snap, device, dtype)


def list_baselines() -> list:
  if not os.path.isdir(ZOO_DIR):
    return []
  return sorted(f[:-4] for f in os.listdir(ZOO_DIR) if f.endswith(".pkl"))


def load_baseline(env_id: str, device="cuda",
                  dtype: torch.dtype = torch.float32) -> Policy:
  """Load the checked-in pretrained policy for an env ID."""
  path = os.path.join(ZOO_DIR, f"{env_id}.pkl")
  if not os.path.isfile(path):
    raise FileNotFoundError(
        f"no zoo baseline for {env_id!r}; available: {list_baselines()}")
  return load_policy(path, device, dtype)

"""Batched env core: MyoSuite tasks stepped as one batch of environments.

Counterpart of ``myosuite_mjx_tpu/envs/base.py``. Where the JAX package
writes one env and ``vmap``s it, every method here takes and returns a
batch: ``EnvState`` fields are ``[B, ...]``.

One control step maps the action to muscle ctrl (sigmoid), runs
``frame_skip`` physics substeps, builds obs, reward and termination, and in
``autoreset_step`` folds in a fresh reset selected per env with
``torch.where``. The first ``frame_skip - 1`` substeps run with
``full_data=False`` (see ``engine/forward.py``): only the fields the next
substep reads are kept up to date, as XLA's dead-code elimination gives
the reference's substep scan.

Randomness: the reference carries a JAX key per env. Here a ``BatchedEnv``
holds one ``torch.Generator`` and hands it to ``reset``. The fixed-target,
init-reset pose task draws nothing from it. Tasks with random targets or
resets draw different numbers than JAX does from the same seed, so their
parity tests must make those inputs with numpy and give them to both.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from myosuite_mjx_tpu_torch.engine import data as data_mod
from myosuite_mjx_tpu_torch.engine import forward as forward_mod
from myosuite_mjx_tpu_torch.engine import model as model_mod
from myosuite_mjx_tpu_torch.engine.data import Data
from myosuite_mjx_tpu_torch.engine.model import DynType, JointType, TrnType


@dataclasses.dataclass
class EnvState:
  """Physics Data plus episode bookkeeping and task state, all [B, ...]."""
  data: Data
  obs: torch.Tensor       # [B, obs_dim]
  reward: torch.Tensor    # [B]
  done: torch.Tensor      # [B] bool
  steps: torch.Tensor     # [B] int32
  info: dict              # rwd_dense, rwd_sparse, solved, terminated, truncated
  aux: dict               # task state (targets, ...)

  def replace(self, **kw) -> "EnvState":
    return dataclasses.replace(self, **kw)


def pin_float32_precision() -> None:
  """Full float32 matmuls and convolutions on the GPU (TF32 off).

  The counterpart of the reference's ``default_matmul_precision("highest")``
  pins: reduced matmul precision corrupted closed-loop behaviour there.
  """
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  torch.set_float32_matmul_precision("highest")


def precision_pinned() -> bool:
  return (not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32
          and torch.get_float32_matmul_precision() == "highest")


def _select(mask: torch.Tensor, a: Any, b: Any) -> Any:
  """Per-env ``where(mask, a, b)`` over tensors, dicts and dataclasses."""
  if isinstance(a, torch.Tensor):
    return torch.where(mask.view((-1,) + (1,) * (a.ndim - 1)), a, b)
  if isinstance(a, dict):
    return {k: _select(mask, a[k], b[k]) for k in a}
  return type(a)(**{f.name: _select(mask, getattr(a, f.name),
                                    getattr(b, f.name))
                    for f in dataclasses.fields(a)})


class MyoEnv:
  """Base class for batched musculoskeletal tasks.

  ``model_path`` is an ``.npz`` written by ``tools/export_model.py``.
  Building a MyoEnv pins float32 matmul precision.
  """

  DEFAULT_OBS_KEYS: list = []
  DEFAULT_RWD_KEYS_AND_WEIGHTS: dict = {}
  # whether reset's forward pass solves constraints (see the reference)
  RESET_CONSTRAINT: bool = True

  def __init__(self, model_path, frame_skip: int = 10,
               obs_keys: list | None = None,
               weighted_reward_keys: dict | None = None,
               normalize_act: bool = True, horizon: int = 100,
               obs_noise: float = 0.0, dtype: torch.dtype = torch.float32,
               muscle_condition: str = "", **task_kwargs):
    if muscle_condition:
      raise NotImplementedError(
          f"muscle_condition={muscle_condition!r} is not ported yet")
    if obs_noise:
      raise NotImplementedError("obs_noise is not ported yet")
    pin_float32_precision()
    self.model = model_mod.load_npz(model_path)
    self.dtype = dtype
    self.frame_skip = frame_skip
    self.horizon = horizon
    self.normalize_act = normalize_act
    m = self.model
    self.obs_keys = list(obs_keys if obs_keys is not None
                         else self.DEFAULT_OBS_KEYS)
    if m.na > 0 and "act" not in self.obs_keys:
      self.obs_keys.append("act")
    self.rwd_keys_wt = dict(weighted_reward_keys
                            or self.DEFAULT_RWD_KEYS_AND_WEIGHTS)
    self.dt = m.opt.timestep * frame_skip

    # init pose: mean of ranges for joints driven by joint transmissions
    init_qpos = np.array(m.qpos0, dtype=np.float64)
    if normalize_act and m.nu:
      jnt_ids = m.actuator_trnid[m.actuator_trntype == TrnType.JOINT, 0]
      lin = np.isin(m.jnt_type, (JointType.SLIDE, JointType.HINGE))
      ids = np.intersect1d(jnt_ids, np.where(lin)[0])
      init_qpos[m.jnt_qposadr[ids]] = m.jnt_range[ids].mean(axis=1)
    self.init_qpos = init_qpos
    self.init_qvel = np.zeros(m.nv)
    self._muscle_mask = np.asarray(m.actuator_dyntype == DynType.MUSCLE)
    self.action_dim = int(m.nu)
    self._device_models: dict[torch.device, model_mod.DeviceModel] = {}
    self._setup(**task_kwargs)

  # ---- template methods -------------------------------------------------

  def _setup(self, **kwargs):
    if kwargs:
      raise TypeError(f"unused task kwargs: {sorted(kwargs)}")

  def reset_aux(self, batch: int, device, generator) -> dict:
    return {}

  def reset_qpos_qvel(self, batch: int, device, aux: dict, generator):
    qpos = torch.as_tensor(self.init_qpos, device=device).to(self.dtype)
    qvel = torch.as_tensor(self.init_qvel, device=device).to(self.dtype)
    return qpos.expand(batch, -1).clone(), qvel.expand(batch, -1).clone()

  def get_obs_dict(self, data: Data, aux: dict) -> dict:
    raise NotImplementedError

  def get_reward_dict(self, obs_dict: dict, data: Data, aux: dict) -> dict:
    raise NotImplementedError

  # ---- helpers ----------------------------------------------------------

  def device_model(self, device) -> model_mod.DeviceModel:
    """The model's constants on ``device`` in this env's dtype (cached)."""
    device = torch.device(device)
    if device not in self._device_models:
      self._device_models[device] = model_mod.DeviceModel(
          self.model, self.dtype, device)
    return self._device_models[device]

  def obsdict2obsvec(self, obs_dict: dict) -> torch.Tensor:
    B = obs_dict[self.obs_keys[0]].shape[0]
    return torch.cat([obs_dict[k].reshape(B, -1) for k in self.obs_keys],
                     dim=1)

  def _action_to_ctrl(self, action: torch.Tensor) -> torch.Tensor:
    """Normalized action [B, nu] -> ctrl (muscle sigmoid projection)."""
    if not self.normalize_act:
      return action
    dm = self.device_model(action.device)
    sig = 1.0 / (1.0 + torch.exp(-5.0 * (action - 0.5)))
    lo = dm.actuator_ctrlrange[:, 0]
    hi = dm.actuator_ctrlrange[:, 1]
    lin = lo + (action + 1.0) * 0.5 * (hi - lo)
    if self.model.na:
      mask = torch.as_tensor(self._muscle_mask, device=action.device)
      return torch.where(mask, sig, lin)
    return lin

  def _mk_state(self, data: Data, aux: dict, steps) -> EnvState:
    obs_dict = self.get_obs_dict(data, aux)
    rwd = self.get_reward_dict(obs_dict, data, aux)
    dense = sum(wt * rwd[key] for key, wt in self.rwd_keys_wt.items())
    B = data.qpos.shape[0]
    done = rwd["done"].to(torch.bool)
    return EnvState(
        data=data,
        obs=self.obsdict2obsvec(obs_dict).to(self.dtype),
        reward=dense.to(self.dtype),
        done=done,
        steps=torch.as_tensor(steps, dtype=torch.int32,
                              device=data.qpos.device).expand(B).clone(),
        info=dict(rwd_dense=dense.to(self.dtype),
                  rwd_sparse=rwd["sparse"].to(self.dtype),
                  solved=rwd["solved"].to(torch.bool),
                  terminated=done,
                  truncated=torch.zeros_like(done)),
        aux=aux)

  # ---- core functions ---------------------------------------------------

  def reset(self, batch: int, device="cpu",
            generator: torch.Generator | None = None) -> EnvState:
    """Fresh episodes for ``batch`` envs on ``device``."""
    dm = self.device_model(device)
    aux = self.reset_aux(batch, dm.device, generator)
    qpos, qvel = self.reset_qpos_qvel(batch, dm.device, aux, generator)
    d = data_mod.make_data(dm, batch, self.dtype, dm.device)
    d = d.replace(qpos=qpos.to(self.dtype), qvel=qvel.to(self.dtype))
    d = forward_mod.forward(dm, d, constraint=self.RESET_CONSTRAINT)
    return self._mk_state(d, aux, 0)

  def step(self, state: EnvState, action: torch.Tensor) -> EnvState:
    """One control step: ctrl from the action, then frame_skip substeps."""
    dm = self.device_model(state.data.qpos.device)
    d = state.data.replace(ctrl=self._action_to_ctrl(action.to(self.dtype)))
    for _ in range(self.frame_skip - 1):
      d = forward_mod.step(dm, d, full_data=False)
    d = forward_mod.step(dm, d, full_data=True)
    return self._mk_state(d, state.aux, state.steps + 1)

  def truncated(self, state: EnvState) -> torch.Tensor:
    return state.steps >= self.horizon

  def autoreset_step(self, state: EnvState, action: torch.Tensor,
                     generator: torch.Generator | None = None) -> EnvState:
    """step() with an automatic reset of every env that is done or at the
    horizon. The result keeps the pre-reset ``done``, reward, rwd_dense,
    rwd_sparse, solved, terminated and truncated; its physics, obs and
    steps are the fresh episode's."""
    nxt = self.step(state, action)
    fresh = self.reset(nxt.obs.shape[0], nxt.obs.device, generator)
    terminated = nxt.done
    truncated = self.truncated(nxt) & ~terminated
    out = _select(terminated | truncated, fresh, nxt)
    return out.replace(
        done=terminated, reward=nxt.reward,
        info={**out.info, "rwd_dense": nxt.info["rwd_dense"],
              "rwd_sparse": nxt.info["rwd_sparse"],
              "solved": nxt.info["solved"],
              "terminated": terminated, "truncated": truncated})


class BatchedEnv:
  """``num_envs`` environments of one MyoEnv on one device."""

  def __init__(self, env: MyoEnv, num_envs: int, device="cpu", seed: int = 0):
    self.env = env
    self.num_envs = num_envs
    self.device = torch.device(device)
    self.generator = torch.Generator(device=self.device).manual_seed(seed)

  def init(self) -> EnvState:
    return self.env.reset(self.num_envs, self.device, self.generator)

  def step(self, state: EnvState, action: torch.Tensor) -> EnvState:
    return self.env.autoreset_step(state, action, self.generator)


def state_from_numpy(tree, device="cpu") -> EnvState:
  """Carry a batched JAX ``EnvState`` (leaves as numpy) into the port; the
  per-env JAX keys (``rng``) have no counterpart and are dropped."""
  t = lambda x: torch.as_tensor(np.array(x), device=device)
  return EnvState(
      data=data_mod.data_from_numpy(tree.data, device), obs=t(tree.obs),
      reward=t(tree.reward), done=t(tree.done), steps=t(tree.steps),
      info={k: t(v) for k, v in tree.info.items()},
      aux={k: t(v) for k, v in tree.aux.items()})

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

Muscle conditions (``muscle_condition``): ``sarcopenia`` halves every
actuator's F_max, ``fatigue`` runs the 3CC-r model (``envs/fatigue.py``) on
the muscle ctrl once per control step, ``reafferentation`` reroutes the
EIP command to EPL. ``obs_noise`` builds obs and reward from a noisy
observed twin of the physics (one more forward pass per state built);
``state.data`` stays the ground truth. ``reset_overlay`` is the hook for
per-env model overlays (``envs/randomize.py``).

Randomness: the reference carries a JAX key per env. Here a ``BatchedEnv``
holds one ``torch.Generator`` and hands it to ``reset`` and ``step``. The
fixed-target, init-reset pose task draws nothing from it. Tasks, conditions
and noise that draw take different numbers than JAX does from the same
seed; their draws go through ``draw_fatigue``, ``draw_obs_noise`` and the
task's hooks, which a parity test overrides to hand in JAX's draws.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from myosuite_mjx_tpu_torch.engine import data as data_mod
from myosuite_mjx_tpu_torch.engine import forward as forward_mod
from myosuite_mjx_tpu_torch.engine import model as model_mod
from myosuite_mjx_tpu_torch.engine import smooth
from myosuite_mjx_tpu_torch.engine.data import Data
from myosuite_mjx_tpu_torch.engine.model import DynType, JointType, TrnType
from myosuite_mjx_tpu_torch.envs import fatigue
from myosuite_mjx_tpu_torch.envs.randomize import uniform
from myosuite_mjx_tpu_torch.utils import spans

MUSCLE_CONDITIONS = ("", "sarcopenia", "fatigue", "reafferentation")


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

  ``model_path`` is an ``.npz`` model (``engine.model.load_npz``; the
  fixtures are written by ``python tests/torch_parity.py --export``).
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
               muscle_condition: str = "",
               fatigue_reset_random: bool = False, **task_kwargs):
    if muscle_condition not in MUSCLE_CONDITIONS:
      raise ValueError(f"muscle_condition {muscle_condition!r} is not one "
                       f"of {MUSCLE_CONDITIONS}")
    pin_float32_precision()
    self.model = model_mod.load_npz(model_path)
    self.muscle_condition = muscle_condition
    self.fatigue_reset_random = fatigue_reset_random
    if muscle_condition == "sarcopenia":
      # weaker muscles: half the max force, on the host model, before any
      # DeviceModel (whose actuation spec caches gainprm) is built
      gp = np.array(self.model.actuator_gainprm)
      gp[:, 2] = 0.5 * gp[:, 2]
      self.model = model_mod.Model(**{**self.model.__dict__,
                                      "actuator_gainprm": gp})
    self.obs_noise = float(obs_noise)
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
    if muscle_condition == "reafferentation":
      # the EIP -> EPL tendon transfer
      self._epl = m.name2id("actuator", "EPL")
      self._eip = m.name2id("actuator", "EIP")
    self._fatigue_idx = np.where(self._muscle_mask)[0]
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

  def reset_overlay(self, batch: int, device, aux: dict, generator) -> dict:
    """Per-env model-constant overrides for the new episodes (domain
    randomization, ``envs/randomize.py``): field -> [B, ...]."""
    return {}

  def post_reset_aux(self, data: Data, aux: dict, generator) -> dict:
    """Task state that depends on the freshly reset physics (a target
    relative to a body's pose, say), after the reset's forward pass.
    Default: unchanged."""
    return aux

  def get_obs_dict(self, data: Data, aux: dict) -> dict:
    raise NotImplementedError

  def get_reward_dict(self, obs_dict: dict, data: Data, aux: dict) -> dict:
    raise NotImplementedError

  # ---- helpers ----------------------------------------------------------

  def device_model(self, device) -> model_mod.DeviceModel:
    """The model's constants on ``device`` in this env's dtype (cached by
    card: ``"cuda"`` is the current card, so it gives ``"cuda:0"``'s
    model when that is current)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
      device = torch.device("cuda", torch.cuda.current_device())
    if device not in self._device_models:
      self._device_models[device] = model_mod.DeviceModel(
          self.model, self.dtype, device)
    return self._device_models[device]

  def sites_at_qpos0(self) -> np.ndarray:
    """Every site's world position [nsite, 3] at qpos0, from the port's
    kinematics in float64 on the CPU (task constants, computed once)."""
    dm = model_mod.DeviceModel(self.model, torch.float64, "cpu")
    d = data_mod.make_data(dm, 1, torch.float64, "cpu")
    kin = smooth.kinematics(dm, torch.as_tensor(self.model.qpos0)[None],
                            mocap_pos=d.mocap_pos, mocap_quat=d.mocap_quat)
    return kin["site_xpos"][0].numpy()

  def act_magnitude(self, act: torch.Tensor) -> torch.Tensor:
    """|act| / na per env (zeros without activations), the act_reg term."""
    mag = torch.linalg.vector_norm(act, dim=-1)
    return mag / self.model.na if self.model.na else torch.zeros_like(mag)

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

  # ---- draws (a parity test overrides these to hand in JAX's) -----------

  def draw_fatigue(self, batch: int, device, generator):
    """Two U(0, 1) draws [B, n_muscles] for ``fatigue.random_state``."""
    shape = (batch, len(self._fatigue_idx))
    return (uniform(shape, generator, device, self.dtype),
            uniform(shape, generator, device, self.dtype))

  def draw_obs_noise(self, data: Data, generator) -> dict:
    """U(-1, 1) draws shaped like qpos, qvel and act."""
    return {k: uniform(tuple(getattr(data, k).shape), generator,
                       data.qpos.device, self.dtype, -1.0, 1.0)
            for k in ("qpos", "qvel", "act")}

  # ---- muscle conditions and observation noise ----------------------------

  def _fatigue_spec(self, dm: model_mod.DeviceModel):
    mus = self._fatigue_idx
    return (torch.as_tensor(mus, device=dm.device),
            dm.tensor(self.model.actuator_dynprm[mus, 0]),
            dm.tensor(self.model.actuator_dynprm[mus, 1]))

  def _apply_muscle_condition(self, ctrl: torch.Tensor, aux: dict):
    """The per-step ctrl transform of the fatigue and reafferentation
    conditions; returns (ctrl, aux)."""
    if self.muscle_condition == "fatigue":
      idx, tauact, taudeact = self.device_model(ctrl.device).spec(
          "fatigue", self._fatigue_spec)
      eff, state = fatigue.compute_act(aux["fatigue"], ctrl[:, idx], tauact,
                                       taudeact, self.dt)
      return ctrl.index_copy(1, idx, eff), {**aux, "fatigue": state}
    if self.muscle_condition == "reafferentation":
      ctrl = ctrl.clone()
      ctrl[:, self._epl] = ctrl[:, self._eip]
      ctrl[:, self._eip] = 0.0
    return ctrl, aux

  def observed_data(self, data: Data, noise: dict) -> Data:
    """The noisy observed twin of the ground-truth physics: obs_noise times
    the U(-1, 1) ``noise`` added to qpos, qvel and act (clipped to [0, 1]),
    then one full forward pass with constraints."""
    s = self.obs_noise
    d = data.replace(qpos=data.qpos + s * noise["qpos"],
                     qvel=data.qvel + s * noise["qvel"])
    if self.model.na:
      d = d.replace(act=torch.clamp(data.act + s * noise["act"], 0.0, 1.0))
    return forward_mod.forward(self.device_model(data.qpos.device), d)

  def _mk_state(self, data: Data, aux: dict, steps,
                generator: torch.Generator | None = None) -> EnvState:
    # obs and reward from the observed Data, as the reference's
    d_obs = (self.observed_data(data, self.draw_obs_noise(data, generator))
             if self.obs_noise else data)
    obs_dict = self.get_obs_dict(d_obs, aux)
    rwd = self.get_reward_dict(obs_dict, d_obs, aux)
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

  def _reset_aux(self, batch: int, device, generator) -> dict:
    """The task's fresh aux, with the fatigue state under that condition."""
    aux = self.reset_aux(batch, device, generator)
    if self.muscle_condition == "fatigue":
      aux["fatigue"] = (
          fatigue.random_state(*self.draw_fatigue(batch, device, generator))
          if self.fatigue_reset_random else
          fatigue.init_state(batch, len(self._fatigue_idx), self.dtype,
                             device))
    return aux

  def _reset_from(self, dm: model_mod.DeviceModel, qpos, qvel, aux: dict,
                  generator) -> EnvState:
    """Fresh Data at qpos/qvel with the episode's overlay, the reset's
    forward pass, then ``post_reset_aux``."""
    batch = qpos.shape[0]
    d = data_mod.make_data(dm, batch, self.dtype, dm.device)
    d = d.replace(qpos=qpos.to(dm.device, self.dtype),
                  qvel=qvel.to(dm.device, self.dtype),
                  overlay=self.reset_overlay(batch, dm.device, aux,
                                             generator))
    d = forward_mod.forward(dm, d, constraint=self.RESET_CONSTRAINT)
    aux = self.post_reset_aux(d, aux, generator)
    return self._mk_state(d, aux, 0, generator)

  def reset(self, batch: int, device="cuda",
            generator: torch.Generator | None = None) -> EnvState:
    """Fresh episodes for ``batch`` envs on ``device`` (the card unless the
    caller asks for the CPU)."""
    dm = self.device_model(device)
    aux = self._reset_aux(batch, dm.device, generator)
    qpos, qvel = self.reset_qpos_qvel(batch, dm.device, aux, generator)
    return self._reset_from(dm, qpos, qvel, aux, generator)

  def reset_to(self, qpos: torch.Tensor, qvel: torch.Tensor,
               generator: torch.Generator | None = None,
               aux: dict | None = None) -> EnvState:
    """Restore exact physics states qpos [B, nq], qvel [B, nv] (on their
    device): a reset with these in place of the task's initial-state
    draw. Without ``aux`` the task draws a fresh one (and the fatigue
    state, under that condition), as ``reset`` does."""
    dm = self.device_model(qpos.device)
    if aux is None:
      aux = self._reset_aux(qpos.shape[0], dm.device, generator)
    return self._reset_from(dm, qpos, qvel, aux, generator)

  def control(self, state: EnvState, action: torch.Tensor):
    """(ctrl [B, nu], aux) for a control step: the action mapped to ctrl,
    then the muscle condition. A task whose controller drives some
    actuators itself overrides this."""
    return self._apply_muscle_condition(
        self._action_to_ctrl(action.to(self.dtype)), state.aux)

  def step(self, state: EnvState, action: torch.Tensor,
           generator: torch.Generator | None = None) -> EnvState:
    """One control step: ctrl from ``control``, then frame_skip
    substeps. The control and the task's part run in their spans, the
    substeps' stages in theirs (``utils/spans.py``)."""
    dm = self.device_model(state.data.qpos.device)
    with spans.span(spans.ENV_CONTROL):
      ctrl, aux = self.control(state, action)
    d = state.data.replace(ctrl=ctrl)
    for _ in range(self.frame_skip - 1):
      d = forward_mod.step(dm, d, full_data=False)
    d = forward_mod.step(dm, d, full_data=True)
    with spans.span(spans.ENV_TASK):
      return self._mk_state(d, aux, state.steps + 1, generator)

  def truncated(self, state: EnvState) -> torch.Tensor:
    return state.steps >= self.horizon

  def autoreset_step(self, state: EnvState, action: torch.Tensor,
                     generator: torch.Generator | None = None) -> EnvState:
    """step() with an automatic reset of every env that is done or at the
    horizon. The result keeps the pre-reset ``done``, reward, rwd_dense,
    rwd_sparse, solved, terminated and truncated; its physics, obs and
    steps are the fresh episode's; an env that resets takes the fresh
    episode's model overlay and condition state, the others keep theirs.
    The reset and the merge run in their spans, and the envs that keep
    their reset feed the reset counter (``utils/spans.py``)."""
    nxt = self.step(state, action, generator)
    with spans.span(spans.ENV_RESET):
      fresh = self.reset(nxt.obs.shape[0], nxt.obs.device, generator)
    with spans.span(spans.ENV_SELECT):
      terminated = nxt.done
      truncated = self.truncated(nxt) & ~terminated
      kept = terminated | truncated
      spans.resets_kept(kept)
      out = _select(kept, fresh, nxt)
      return out.replace(
          done=terminated, reward=nxt.reward,
          info={**out.info, "rwd_dense": nxt.info["rwd_dense"],
                "rwd_sparse": nxt.info["rwd_sparse"],
                "solved": nxt.info["solved"],
                "terminated": terminated, "truncated": truncated})


class BatchedEnv:
  """``num_envs`` environments of one MyoEnv on one device (the card unless
  the caller asks for the CPU)."""

  def __init__(self, env: MyoEnv, num_envs: int, device="cuda", seed: int = 0):
    self.env = env
    self.num_envs = num_envs
    self.device = torch.device(device)
    self.generator = torch.Generator(device=self.device).manual_seed(seed)

  def init(self) -> EnvState:
    return self.env.reset(self.num_envs, self.device, self.generator)

  def step(self, state: EnvState, action: torch.Tensor) -> EnvState:
    return self.env.autoreset_step(state, action, self.generator)


def state_from_numpy(tree, device="cuda") -> EnvState:
  """Carry a batched JAX ``EnvState`` (leaves as numpy) into the port; the
  per-env JAX keys (``rng``) have no counterpart and are dropped."""
  def t(x):
    if isinstance(x, dict):
      return {k: t(v) for k, v in x.items()}
    return torch.as_tensor(np.array(x), device=device)

  return EnvState(
      data=data_mod.data_from_numpy(tree.data, device), obs=t(tree.obs),
      reward=t(tree.reward), done=t(tree.done), steps=t(tree.steps),
      info=t(tree.info), aux=t(tree.aux))

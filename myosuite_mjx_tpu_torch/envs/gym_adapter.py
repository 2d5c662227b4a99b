"""Gymnasium-compatible adapter over the batch-first envs.

Counterpart of ``myosuite_mjx_tpu/envs/gym_adapter.py``: the reference's
product surface is the gym API, ``gym.make(id)`` and then the 5-tuple
``step`` with Box spaces, and a user switching from it gets the same here:

    from myosuite_mjx_tpu_torch.envs import gym_make
    env = gym_make("hand23PoseFixed-v0", seed=0)
    obs, info = env.reset()
    obs, reward, terminated, truncated, info = env.step(
        env.action_space.sample())

``GymEnv`` is one env: a batch of one of the batched ``MyoEnv``, whose
obs and reward come to the host as numpy each step. ``GymVecEnv``
(``num_envs > 1``) is ``BatchedEnv``'s surface: batched obs and autoreset,
with the pre-reset ``terminated`` and ``truncated`` flags. The physics
stays on ``device`` (the card unless the caller asks for the CPU). Draws
come from a ``torch.Generator`` seeded with ``seed`` (and re-seeded by
``reset(seed=...)``); both adapters pickle with it and their state.

``gymnasium`` is imported if it is installed. Without it the adapter still
resets and steps, but has no ``action_space`` or ``observation_space``
(and ``GymEnv`` is a plain class, not a ``gymnasium.Env``).
"""
from __future__ import annotations

import numpy as np
import torch

try:
  import gymnasium
  from gymnasium import spaces as gym_spaces
  _GYM_BASE = gymnasium.Env
except ImportError:          # keep the package importable without gymnasium
  gymnasium = None
  gym_spaces = None
  _GYM_BASE = object

from myosuite_mjx_tpu_torch.envs import registry
from myosuite_mjx_tpu_torch.envs.base import BatchedEnv, MyoEnv


def _box(shape: tuple, low: float, high: float):
  return gym_spaces.Box(low=low, high=high, shape=shape, dtype=np.float32)


def _host(x: torch.Tensor) -> np.ndarray:
  return x.detach().cpu().numpy()


def _obs_dim(env: MyoEnv, device) -> int:
  """The obs width, from a reset that draws from a generator of its own."""
  g = torch.Generator(device=device)
  return int(env.reset(1, device, g).obs.shape[-1])


class GymEnv(_GYM_BASE):
  """One env of a MyoEnv as a ``gymnasium.Env``."""

  metadata = {"render_modes": []}

  def __init__(self, env: MyoEnv, seed: int = 0, device="cuda"):
    self._env = env
    self.device = torch.device(device)
    self._generator = torch.Generator(device=self.device).manual_seed(seed)
    self._state = None
    if gym_spaces is not None:
      obs_dim = _obs_dim(env, self.device)
      self.action_space = _box((env.action_dim,), -1.0, 1.0)
      self.observation_space = _box((obs_dim,), -np.inf, np.inf)

  @property
  def unwrapped_myo(self) -> MyoEnv:
    return self._env

  @property
  def horizon(self) -> int:
    return self._env.horizon

  def reset(self, *, seed: int | None = None, options=None):
    if seed is not None:
      self._generator.manual_seed(seed)
    self._state = self._env.reset(1, self.device, self._generator)
    return _host(self._state.obs[0]), self._info()

  def step(self, action):
    a = torch.as_tensor(np.asarray(action), device=self.device)[None]
    st = self._env.step(self._state, a, self._generator)
    self._state = st
    terminated = bool(st.done[0])
    truncated = bool(st.steps[0] >= self._env.horizon) and not terminated
    return (_host(st.obs[0]), float(st.reward[0]), terminated, truncated,
            self._info())

  def _info(self) -> dict:
    return {k: _host(v[0]) for k, v in self._state.info.items()}

  def close(self):
    pass


class GymVecEnv:
  """``num_envs`` envs as one vectorized surface (SB3 VecEnv / gymnasium
  VectorEnv shapes): batched obs and reward with autoreset on done."""

  def __init__(self, env: MyoEnv, num_envs: int, seed: int = 0,
               device="cuda"):
    self._env = env
    self.num_envs = num_envs
    self._benv = BatchedEnv(env, num_envs, device, seed)
    self.device = self._benv.device
    self._state = None
    if gym_spaces is not None:
      obs_dim = _obs_dim(env, self.device)
      self.single_action_space = _box((env.action_dim,), -1.0, 1.0)
      self.single_observation_space = _box((obs_dim,), -np.inf, np.inf)
      self.action_space = _box((num_envs, env.action_dim), -1.0, 1.0)
      self.observation_space = _box((num_envs, obs_dim), -np.inf, np.inf)

  def reset(self, *, seed: int | None = None):
    if seed is not None:
      self._benv.generator.manual_seed(seed)
    self._state = self._benv.init()
    return _host(self._state.obs), {}

  def step(self, actions):
    st = self._benv.step(self._state, torch.as_tensor(
        np.asarray(actions), device=self.device))
    self._state = st
    # the pre-reset episode flags (obs and physics are the fresh episode's)
    return (_host(st.obs), _host(st.reward), _host(st.info["terminated"]),
            _host(st.info["truncated"]),
            {k: _host(v) for k, v in st.info.items()})


def gym_make(env_id: str, seed: int = 0, num_envs: int = 1, device="cuda",
             **kwargs):
  """``gym.make`` over the registry: ``GymEnv`` for one env, else
  ``GymVecEnv``; ``kwargs`` override the task's."""
  env = registry.make(env_id, **kwargs)
  if num_envs == 1:
    return GymEnv(env, seed=seed, device=device)
  return GymVecEnv(env, num_envs, seed=seed, device=device)

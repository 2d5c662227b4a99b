"""The plain reference of one batched control step with its autoreset.

``make_env`` builds the reference task named in a traffic file
(``"reference": {"class": "<module>.<Class>", "kwargs": {...}}``) on the
configuration's scene. ``autoreset_rows`` recomputes, for a block of rows,
what the program's ``autoreset_step`` produced from the same inputs: the
state before the step, the action, and the fresh episode drawn for the
reset, whose draws ``reset_inputs`` replays from the seed.
"""
from __future__ import annotations

import importlib

import torch

from . import data as data_mod
from .base import EnvState, _select

# the fields of the state that a control step reads (the rest of Data is
# recomputed from them), and those it produces that are compared
STATE_KEYS = ("time", "qpos", "qvel", "act", "qacc_warmstart")


def make_env(spec: dict, scene: str, dtype: torch.dtype):
  module, cls = spec["class"].split(".")
  mod = importlib.import_module(f"{__package__}.{module}")
  return getattr(mod, cls)(model_path=scene, dtype=dtype, **spec["kwargs"])


def reset_inputs(env, batch: int, device, generator) -> dict:
  """The draws of one reset of ``batch`` envs, in the order ``reset`` makes
  them: the task's aux, then qpos and qvel, then the overlay."""
  aux = env._reset_aux(batch, device, generator)
  qpos, qvel = env.reset_qpos_qvel(batch, device, aux, generator)
  overlay = env.reset_overlay(batch, device, aux, generator)
  return {"aux": aux, "qpos": qpos, "qvel": qvel, "overlay": overlay}


def _rows(x, rows):
  if isinstance(x, dict):
    return {k: _rows(v, rows) for k, v in x.items()}
  return x[rows]


def fresh_rows(env, inputs: dict, rows, device) -> EnvState:
  """The reset of the envs ``rows`` from the reset's draws."""
  dm = env.device_model(device)
  r = {k: _rows(v, rows) for k, v in inputs.items()}
  t = lambda x: x.to(device=device, dtype=env.dtype)
  qpos, qvel = t(r["qpos"]), t(r["qvel"])
  d = data_mod.make_data(dm, qpos.shape[0], env.dtype, device)
  d = d.replace(qpos=qpos, qvel=qvel,
                overlay={k: t(v) for k, v in r["overlay"].items()})
  from . import forward as forward_mod
  d = forward_mod.forward(dm, d, constraint=env.RESET_CONSTRAINT)
  aux = {k: t(v) if v.is_floating_point() else v.to(device)
         for k, v in r["aux"].items()}
  aux = env.post_reset_aux(d, aux, None)
  return env._mk_state(d, aux, 0, None)


def state_rows(env, pre: dict, rows, device) -> EnvState:
  """The state before the step for ``rows``, from the fields a step reads
  (``pre``: ``STATE_KEYS``, ``steps`` and ``aux.<key>``)."""
  dm = env.device_model(device)
  t = lambda x: x[rows].to(device=device, dtype=env.dtype)
  n = pre["qpos"][rows].shape[0]
  d = data_mod.make_data(dm, n, env.dtype, device)
  d = d.replace(**{k: t(pre[k]) for k in STATE_KEYS})
  aux = {k[4:]: (t(v) if v.is_floating_point() else v[rows].to(device))
         for k, v in pre.items() if k.startswith("aux.")}
  return EnvState(data=d, obs=None, reward=None, done=None,
                  steps=pre["steps"][rows].to(device), info={}, aux=aux)


def autoreset_rows(env, pre: dict, action: torch.Tensor, inputs: dict, rows,
                   device) -> dict:
  """The autoreset step of the envs ``rows``: step, then the fresh episode
  where the step terminated or reached the horizon. Returns the compared
  fields."""
  state = state_rows(env, pre, rows, device)
  nxt = env.step(state, action[rows].to(device=device, dtype=env.dtype))
  fresh = fresh_rows(env, inputs, rows, device)
  terminated = nxt.done
  truncated = env.truncated(nxt) & ~terminated
  out = _select(terminated | truncated, fresh, nxt)
  return {"qpos": out.data.qpos, "qvel": out.data.qvel, "act": out.data.act,
          "obs": out.obs, "reward": nxt.reward, "steps": out.steps,
          "done": terminated, "truncated": truncated}


def reset_rows(env, inputs: dict, rows, device) -> dict:
  """The compared fields of the first reset, for ``rows``."""
  st = fresh_rows(env, inputs, rows, device)
  return {"qpos": st.data.qpos, "qvel": st.data.qvel, "act": st.data.act,
          "obs": st.obs, "reward": st.reward, "steps": st.steps,
          "done": st.done, "truncated": st.info["truncated"]}

"""Faults planted under the timed path, to show that ``correct`` catches
them: the benchmark's tests plant each and see ``correct`` come out false,
and ``control.py --fault`` reads them on the card.

- ``unchanged``: the env step returns its state as it was;
- ``altered``: the env step's answer for one env (row 0) is another env's
  (row 1's whole next state: physics, obs, reward, clock, flags and task
  state), an indexing fault where it is made.
"""
from __future__ import annotations


def _patch_env_step(wrap) -> None:
  from myosuite_mjx_tpu_torch.envs import base
  inner = base.BatchedEnv.step

  def step(self, state, action):
    return wrap(state, inner(self, state, action))

  base.BatchedEnv.step = step


def _unchanged(state, out):
  return state


def _altered(state, out):
  import dataclasses

  import torch

  def row0_from_row1(x):
    if isinstance(x, torch.Tensor):
      return x.index_copy(0, torch.zeros(1, dtype=torch.long,
                                         device=x.device), x[1:2])
    if isinstance(x, dict):
      return {k: row0_from_row1(v) for k, v in x.items()}
    return dataclasses.replace(x, **{f.name: row0_from_row1(getattr(x, f.name))
                                     for f in dataclasses.fields(x)})

  return row0_from_row1(out)


FAULTS = {
    "unchanged": lambda: _patch_env_step(_unchanged),
    "altered": lambda: _patch_env_step(_altered),
}


def plant(name: str) -> None:
  FAULTS[name]()

"""Success-driven curriculum schedule.

Counterpart of ``myosuite_mjx_tpu/utils/curriculum.py``: an EMA filter of
the success, and a value that ramps from ``start`` to ``end`` at ``rate``
while both the instantaneous success and the filtered progress reach
``threshold``.

Two forms, as there: ``CurriculumState`` with ``init`` / ``update`` /
``status``, branchless functions over a state of tensors that can stay on
the device inside a training loop (no host sync); and ``Curriculum``, a
host-side object with the reference class's API.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class CurriculumState(NamedTuple):
  value: torch.Tensor     # scalar: the curriculum's progress in [0, 1 + rate]
  progress: torch.Tensor  # scalar: EMA of the success


def init(dtype: torch.dtype = torch.float32, device="cuda") -> CurriculumState:
  zero = torch.zeros((), dtype=dtype, device=device)
  return CurriculumState(zero, zero.clone())


def update(state: CurriculumState, current_success,
           threshold: float = 90.0, rate: float = 0.01,
           filter_coef: float = 0.95) -> CurriculumState:
  """One curriculum update, branchless."""
  progress = state.progress * filter_coef + current_success * (
      1.0 - filter_coef)
  bump = ((state.value <= 1.0)
          & (torch.as_tensor(current_success, device=state.value.device)
             >= threshold)
          & (progress >= threshold))
  value = state.value + bump.to(state.value.dtype) * rate
  return CurriculumState(value, progress.to(state.progress.dtype))


def status(state: CurriculumState, start: float = 0.0,
           end: float = 1.0) -> torch.Tensor:
  """The current curriculum setting."""
  return start + state.value * (end - start)


class Curriculum:
  """Host-side stateful wrapper with the reference class's API; its state
  is float64 on the CPU."""

  def __init__(self, threshold=90.0, rate=1.0 / 100.0, start=0.0, end=1.0,
               filter_coef=0.95):
    if not rate > 0:
      raise ValueError("rate should always be positive")
    self._threshold = threshold
    self._rate = rate
    self._start = start
    self._end = end
    self._filter_coef = filter_coef
    self._state = init(torch.float64, "cpu")

  def update(self, current_success):
    self._state = update(self._state, float(current_success),
                         threshold=self._threshold, rate=self._rate,
                         filter_coef=self._filter_coef)

  def status(self) -> float:
    return float(status(self._state, self._start, self._end))

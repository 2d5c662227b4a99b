"""Public engine API: a physics handle for one model on one device.

Counterpart of ``myosuite_mjx_tpu/engine/api.py``. The JAX ``Physics``
closes jitted single-env functions over a model and ``vmap``s them for a
batch; the port's engine is batch-first, so ``step`` and ``step_batch``
are one function (as are ``forward`` and ``forward_batch``): every
``Data`` holds a batch, of one env or of many.

    phys = load("myosuite_mjx_tpu_torch/assets/free10.npz", device="cuda")
    d = phys.make_data(4096)
    d = phys.step_n(10)(d)
"""
from __future__ import annotations

import functools

import torch

from myosuite_mjx_tpu_torch.engine import data as data_mod
from myosuite_mjx_tpu_torch.engine import forward as forward_mod
from myosuite_mjx_tpu_torch.engine import model as model_mod
from myosuite_mjx_tpu_torch.engine.data import Data
from myosuite_mjx_tpu_torch.engine.model import Model


class Physics:
  """Physics of one model on one device (the card unless the caller asks
  for the CPU), in ``dtype``. Building it pins float32 matmul precision,
  as building a ``MyoEnv`` does."""

  def __init__(self, m: Model, dtype: torch.dtype = torch.float32,
               device="cuda"):
    from myosuite_mjx_tpu_torch.envs.base import pin_float32_precision
    pin_float32_precision()
    self.model = m
    self.dtype = dtype
    self.device_model = model_mod.DeviceModel(m, dtype, device)
    self.device = self.device_model.device

  def make_data(self, batch: int = 1) -> Data:
    """A fresh batch at qpos0 (mocap bodies at the origin, as in the
    reference); run ``forward`` to fill the derived fields."""
    return data_mod.make_data(self.device_model, batch, self.dtype,
                              self.device)

  def step(self, d: Data) -> Data:
    """One physics substep of every env in ``d``."""
    return forward_mod.step(self.device_model, d)

  def forward(self, d: Data) -> Data:
    """Forward dynamics at the current state of every env in ``d``."""
    return forward_mod.forward(self.device_model, d)

  step_batch = step
  forward_batch = forward

  def step_n(self, n: int):
    """A function advancing a Data by ``n`` substeps (a frame-skip loop);
    the substeps before the last skip the diagnostics nothing reads (see
    ``engine/forward.py``), as a control step does."""
    def advance(d: Data) -> Data:
      for _ in range(n - 1):
        d = forward_mod.step(self.device_model, d, full_data=False)
      return forward_mod.step(self.device_model, d) if n else d
    return advance


@functools.lru_cache(maxsize=64)
def _cached_physics(path: str, dtype: torch.dtype, device: str) -> Physics:
  return Physics(model_mod.load_npz(path), dtype, device)


def load(path: str, dtype: torch.dtype = torch.float32,
         device="cuda") -> Physics:
  """A cached ``Physics`` for an exported ``.npz`` model (see
  ``engine/model.py``: the card's machine has no MJCF compiler)."""
  return _cached_physics(path, dtype, str(torch.device(device)))

"""Small constant tensors of the engine's stages, made once per dtype and
device.

``like.new_tensor(values)`` copies from the host at every call: on the card
that stalls the stream, and a CUDA graph cannot capture it; nor can it
capture a Python number written through a tensor index, which is copied
from the host too. ``const`` makes the same tensor once and hands it out
again; callers only read it.
"""
from __future__ import annotations

import torch

_made: dict = {}


def const(values, like: torch.Tensor) -> torch.Tensor:
  """``like.new_tensor(values)`` for a number or a (nested) tuple of
  numbers, cached by (values, like's dtype, like's device)."""
  key = (values, like.dtype, like.device)
  t = _made.get(key)
  if t is None:
    t = _made[key] = like.new_tensor(values)
  return t

"""Visual observations: the rgb key grammar and pluggable encoders.

Counterpart of ``myosuite_mjx_tpu/envs/visual.py``, without its
``VisualObs``: the pixels come from a host renderer that needs MuJoCo,
which the port does not use. Kept: the visual keys' grammar

    'rgb:<cam_name>:<H>x<W>:<encoder>'

and the encoders ``1d`` (flattened frames), ``2d`` (frames as they are)
and ``flax_cnn``, the small convnet of the JAX package as an
``nn.Module`` (the id stays, so visual keys mean the same in both
packages). ``encoder_from_flax`` carries the Flax net's parameters into
it; ``register_encoder`` plugs in others.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F


def parse_visual_key(key: str):
  """'rgb:cam:HxW:enc' -> (cam, height, width, encoder_id), split from the
  right so that camera names containing ':' survive."""
  if not key.startswith("rgb:"):
    raise ValueError(f"unsupported visual key {key!r}")
  payload = key[4:]
  enc = payload.split(":")[-1]
  payload = payload[: -(len(enc) + 1)]
  wxh = payload.split(":")[-1]
  cam = payload[: -(len(wxh) + 1)]
  h, w = (int(x) for x in wxh.split("x"))
  return cam, h, w, enc


# the Flax net's convolutions: features per layer, 3 x 3, stride 2, SAME
_CONV_FEATURES = (16, 32, 32)
_TRUNC_STD = 0.87962566103423978    # flax lecun_normal's truncation


def _same_pads(n: int) -> tuple[int, int]:
  """Flax's SAME padding of a 3-wide, stride-2 window over n: out =
  ceil(n / 2); the extra row (or column) of an odd total goes at the
  end."""
  total = max((math.ceil(n / 2) - 1) * 2 + 3 - n, 0)
  return total // 2, total - total // 2


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator) -> None:
  std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
  nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                        generator=generator)


class FlaxCNNEncoder(nn.Module):
  """Frames [N, H, W, 3] uint8 -> [N, out_dim]: three ReLU convolutions
  (16, 32, 32 features, 3 x 3, stride 2, SAME padding), then a dense
  layer over the flattened [H', W', C] map, as the JAX package's Flax
  net. Pixels are scaled by 1 / 255 in float32, as there, then computed in
  ``dtype``. Weights start as flax's ``lecun_normal`` (biases zero), from
  ``seed``."""

  def __init__(self, height: int = 84, width: int = 84, out_dim: int = 64,
               seed: int = 0, dtype: torch.dtype = torch.float32,
               device="cuda"):
    super().__init__()
    g = torch.Generator().manual_seed(seed)
    self.out_dim = out_dim
    self.convs = nn.ModuleList()
    cin, h, w = 3, height, width
    for feat in _CONV_FEATURES:
      conv = nn.Conv2d(cin, feat, 3, stride=2, dtype=torch.float64)
      with torch.no_grad():
        _lecun_normal_(conv.weight, 9 * cin, g)
        conv.bias.zero_()
      self.convs.append(conv)
      cin, h, w = feat, math.ceil(h / 2), math.ceil(w / 2)
    self.dense = nn.Linear(h * w * cin, out_dim, dtype=torch.float64)
    with torch.no_grad():
      _lecun_normal_(self.dense.weight, h * w * cin, g)
      self.dense.bias.zero_()
    self.to(device=device, dtype=dtype)

  def forward(self, frames: torch.Tensor) -> torch.Tensor:
    w0 = self.dense.weight
    x = (frames.to(w0.device, torch.float32) / 255.0).to(w0.dtype)
    x = x.permute(0, 3, 1, 2)                       # NHWC -> NCHW
    for conv in self.convs:
      top, bottom = _same_pads(x.shape[-2])
      left, right = _same_pads(x.shape[-1])
      x = F.relu(conv(F.pad(x, (left, right, top, bottom))))
    # flatten in flax's [H', W', C] order
    return self.dense(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))


def encoder_from_flax(params: dict, height: int = 84, width: int = 84,
                      dtype: torch.dtype = torch.float32,
                      device="cuda") -> FlaxCNNEncoder:
  """A ``FlaxCNNEncoder`` holding the Flax net's parameters
  (``{"params": {"Conv_0": {"kernel", "bias"}, ..., "Dense_0": ...}}``,
  as numpy): HWIO kernels become OIHW weights, the dense kernel [in, out]
  the ``nn.Linear`` weight [out, in]."""
  p = params["params"]
  leaf = lambda name, k: np.array(p[name][k], np.float64)
  dense = leaf("Dense_0", "kernel")
  enc = FlaxCNNEncoder(height, width, dense.shape[1], dtype=torch.float64,
                       device="cpu")
  if enc.dense.weight.shape[1] != dense.shape[0]:
    raise ValueError(f"a {height} x {width} frame flattens to "
                     f"{enc.dense.weight.shape[1]} features, the Flax "
                     f"dense layer takes {dense.shape[0]}")
  t = lambda x: torch.as_tensor(np.ascontiguousarray(x))
  with torch.no_grad():
    for i, conv in enumerate(enc.convs):
      conv.weight.copy_(t(leaf(f"Conv_{i}", "kernel").transpose(3, 2, 0, 1)))
      conv.bias.copy_(t(leaf(f"Conv_{i}", "bias")))
    enc.dense.weight.copy_(t(dense.T))
    enc.dense.bias.copy_(t(leaf("Dense_0", "bias")))
  return enc.to(device=device, dtype=dtype)


_ENCODERS = {
    "1d": lambda frames: frames.reshape(len(frames), -1),
    "2d": lambda frames: frames,
}


def register_encoder(name: str, fn):
  """Plug in a custom encoder callable frames [N, H, W, 3] -> features."""
  _ENCODERS[name] = fn


def encoder(name: str, height: int, width: int, device="cuda"):
  """The callable of an encoder id: a registered one, or a fresh
  ``FlaxCNNEncoder`` for ``flax_cnn`` (on ``device``, the card unless the
  caller asks for the CPU)."""
  if name in _ENCODERS:
    return _ENCODERS[name]
  if name == "flax_cnn":
    return FlaxCNNEncoder(height, width, device=device)
  raise ValueError(f"unknown encoder {name!r}; available: "
                   f"{sorted(_ENCODERS) + ['flax_cnn']}")

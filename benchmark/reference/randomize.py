"""Plain reference, frozen from the port's ``envs/randomize.py`` and
importing nothing of it.

Domain randomization: per-env model overlays drawn at reset.

Counterpart of ``myosuite_mjx_tpu/envs/randomize.py``: body mass, body
position, geom size and friction, dof damping and actuator gain, each drawn
uniformly per env and put on ``Data.overlay``, which the engine reads in
place of the model's constants. One model serves a batch of different
physics; nothing is recompiled.

``sample_overlay`` draws from a ``torch.Generator``; ``overlay_from_draws``
takes the draws, so that a test can hand in the JAX package's. Usage inside
a task's ``reset_overlay``:

    spec = RandomizeSpec(body_mass=(0.8, 1.2), dof_damping=(0.5, 2.0))
    overlay = sample_overlay(env.model, spec, batch, generator, device)
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .model import BiasType, GainType


@dataclasses.dataclass(frozen=True)
class RandomizeSpec:
  """Uniform multiplicative scale ranges (lo, hi) per model field; None
  leaves the field nominal. ``body_pos`` is additive in meters."""
  body_mass: tuple | None = None          # scales model.body_mass
  body_pos: tuple | None = None           # adds U(lo, hi) per coordinate
  geom_size: tuple | None = None          # scales model.geom_size
  geom_friction: tuple | None = None      # scales model.geom_friction
  dof_damping: tuple | None = None        # scales model.dof_damping
  actuator_gain: tuple | None = None      # scales the force parameter


def uniform(shape: tuple, generator: torch.Generator | None, device,
            dtype: torch.dtype, lo: float = 0.0, hi: float = 1.0):
  """U(lo, hi) of ``shape`` on ``device`` in ``dtype``, drawn in float64
  where ``generator`` lives: a CPU generator gives the card and the CPU the
  same numbers, and one on the card draws there."""
  where = generator.device if generator is not None else device
  u = torch.rand(shape, generator=generator, device=where,
                 dtype=torch.float64)
  return (lo + (hi - lo) * u).to(device=device, dtype=dtype)


def normal(shape: tuple, generator: torch.Generator | None, device,
           dtype: torch.dtype):
  """Standard normal draws of ``shape``, made as ``uniform``'s are."""
  where = generator.device if generator is not None else device
  z = torch.randn(shape, generator=generator, device=where,
                  dtype=torch.float64)
  return z.to(device=device, dtype=dtype)


def draw_shapes(model, spec: RandomizeSpec, batch: int) -> dict:
  """The shape of each field's draw: one scale per row of the field, and
  one offset per body coordinate."""
  m = getattr(model, "host", model)
  shapes = dict(body_mass=(batch, m.nbody), body_pos=(batch, m.nbody, 3),
                geom_size=(batch, m.ngeom), geom_friction=(batch, m.ngeom),
                dof_damping=(batch, m.nv), actuator_gain=(batch, m.nu))
  return {k: v for k, v in shapes.items() if getattr(spec, k) is not None}


def sample_overlay(model, spec: RandomizeSpec, batch: int,
                   generator: torch.Generator | None = None, device="cuda",
                   dtype: torch.dtype = torch.float32) -> dict:
  """One overlay per env, [B, ...] per field (see ``overlay_from_draws``)."""
  draws = {k: uniform(shape, generator, device, dtype, *getattr(spec, k))
           for k, shape in draw_shapes(model, spec, batch).items()}
  return overlay_from_draws(model, draws, dtype)


def overlay_from_draws(model, draws: dict,
                       dtype: torch.dtype = torch.float32) -> dict:
  """The overlay from given U(lo, hi) draws, keyed by ``RandomizeSpec``
  field with the shapes of ``draw_shapes``; ``model`` is a host ``Model``
  or a ``DeviceModel``. The world body (index 0) never moves. A muscle's
  gain scales F_max (``gainprm[:, 2]``) and its passive force with it
  (``biasprm[:, 2]``); any other actuator's gain scales ``gainprm[:, 0]``,
  and an affine bias's -kp and -kv (``biasprm[:, 1:3]``) with it."""
  m = getattr(model, "host", model)
  overlay = {}

  def nominal(field, like):
    return torch.as_tensor(np.asarray(getattr(m, field), np.float64),
                           device=like.device).to(dtype)

  def scaled(field, s):
    x = nominal(field, s)
    return x * s.reshape(s.shape + (1,) * (x.ndim - 1))

  for field in ("body_mass", "geom_size", "geom_friction", "dof_damping"):
    if field in draws:
      overlay[field] = scaled(field, draws[field])
  if "body_pos" in draws:
    delta = draws["body_pos"].clone()
    delta[:, 0] = 0.0
    overlay["body_pos"] = nominal("body_pos", delta) + delta
  if "actuator_gain" in draws:
    s = draws["actuator_gain"]                                  # [B, nu]
    is_muscle = np.asarray(m.actuator_gaintype) == GainType.MUSCLE
    is_affine = ((np.asarray(m.actuator_biastype) == BiasType.AFFINE)
                 & ~is_muscle)
    one = torch.ones_like(s)
    mask = lambda x: torch.as_tensor(x, device=s.device)[None]
    gain = nominal("actuator_gainprm", s).expand(s.shape[0], -1, -1).clone()
    rows = torch.arange(m.nu, device=s.device)
    col = torch.as_tensor(np.where(is_muscle, 2, 0), device=s.device)
    gain[:, rows, col] = gain[:, rows, col] * s
    bias = nominal("actuator_biasprm", s).expand(s.shape[0], -1, -1).clone()
    bias[..., 2] = bias[..., 2] * torch.where(mask(is_muscle | is_affine), s,
                                              one)
    bias[..., 1] = bias[..., 1] * torch.where(mask(is_affine), s, one)
    overlay["actuator_gainprm"] = gain
    overlay["actuator_biasprm"] = bias
  return overlay

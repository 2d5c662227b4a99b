"""Procedural terrain for a batch of environments, and the local heightmap.

Counterpart of ``myosuite_mjx_tpu/envs/heightfields.py``: the generators
(``flat``, ``rough``, ``hilly``, ``relief``, ``stairs``), the quadrant
field of the chase-tag task (``ChaseTagField``), the per-segment track
(``TrackField``), the run-track challenge's patches
(``ChallengeTrackField``) and ``local_heightmap``. A field is one
``hfield_data`` overlay per env, [B, nrow * ncol], which the collision
stage reads in place of the model's heights.

Each random generator is split in two, as ``envs/randomize.py`` is: a draw
step that takes its uniform numbers from a ``torch.Generator``
(``draw_*`` / ``*.draw``) and a ``*_from_draws`` step that builds the
field from them, so that a test can hand in the JAX package's draws. Every
draw carries the batch as its leading axis. The generators compute in
their draws' dtype. ``ChaseTagField`` and ``TrackField`` return float32
fields whatever the env's dtype, as the reference does (its generators
default to float32): from float32 draws, each generator computed in
float64 and rounded once to float32, so that the card and the CPU build
the same field bit for bit (their float32 ``exp`` and ``cumsum`` differ
in the last bit); the reference's float32 arithmetic agrees within an
ulp.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from myosuite_mjx_tpu_torch.envs.randomize import uniform


def flat(batch: int, shape, dtype=torch.float32, device="cuda"):
  return torch.zeros((batch,) + tuple(shape), dtype=dtype, device=device)


def draw_rough(batch: int, shape, generator, device, dtype):
  """U(0, 1) [B, *shape]."""
  return uniform((batch,) + tuple(shape), generator, device, dtype)


def rough_from_draws(u, amplitude=1.0):
  """White-noise rubble: amplitude * u."""
  return amplitude * u


def draw_hilly(batch: int, generator, device, dtype):
  """The phases p1, p2 [B] in U(0, 2 pi) and the frequencies w [B, 2] in
  U(0.5, 1.5)."""
  return (uniform((batch,), generator, device, dtype, 0, 2 * math.pi),
          uniform((batch,), generator, device, dtype, 0, 2 * math.pi),
          uniform((batch, 2), generator, device, dtype, 0.5, 1.5))


def hilly_from_draws(draws, shape, periods=3.0, amplitude=1.0):
  """Smooth hills (a product of two sinusoids) [B, nrow, ncol]."""
  p1, p2, w = draws
  nrow, ncol = shape
  like = dict(dtype=p1.dtype, device=p1.device)
  y = torch.linspace(0, 2 * math.pi * periods, nrow, **like)[:, None]
  x = torch.linspace(0, 2 * math.pi * periods, ncol, **like)[None, :]
  h = (torch.sin(w[:, 0, None, None] * x + p1[:, None, None])
       * torch.cos(w[:, 1, None, None] * y + p2[:, None, None]) + 1.0) * 0.5
  return amplitude * h


def draw_relief(batch: int, shape, generator, device, dtype, n_bumps=8):
  """Bump centres cy [B, n] in U(0, nrow), cx in U(0, ncol) and widths
  sig in U(1, min(shape) / 6)."""
  nrow, ncol = shape
  return (uniform((batch, n_bumps), generator, device, dtype, 0, nrow),
          uniform((batch, n_bumps), generator, device, dtype, 0, ncol),
          uniform((batch, n_bumps), generator, device, dtype, 1.0,
                  float(min(shape)) / 6))


def relief_from_draws(draws, shape, amplitude=1.0):
  """Isolated gaussian bumps, their sum clipped to 1 [B, nrow, ncol]."""
  cy, cx, sig = (x[:, None, None, :] for x in draws)
  nrow, ncol = shape
  like = dict(dtype=cy.dtype, device=cy.device)
  yy = torch.arange(nrow, **like)[:, None, None]
  xx = torch.arange(ncol, **like)[None, :, None]
  bumps = torch.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig ** 2)))
  return amplitude * torch.clamp(bumps.sum(-1), 0, 1)


def draw_stairs(batch: int, generator, device, dtype, n_steps=8):
  """Step rises [B, n_steps] in U(0.3, 1)."""
  return uniform((batch, n_steps), generator, device, dtype, 0.3, 1.0)


def stairs_from_draws(u, shape, amplitude=1.0):
  """A staircase along the row axis, the rises normalized to end at 1."""
  nrow, ncol = shape
  n_steps = u.shape[-1]
  heights = torch.cumsum(u, -1)
  heights = heights / heights[:, -1:]
  idx = np.clip((np.arange(nrow) * n_steps) // nrow, 0, n_steps - 1)
  rows = heights[:, torch.as_tensor(idx, device=u.device)]
  return amplitude * rows[:, :, None].expand(-1, nrow, ncol)


def _f32(x: torch.Tensor) -> torch.Tensor:
  return x.to(torch.float32)


def _as32(fn, draws, *args, **kwargs):
  """``fn`` of float32-rounded draws (one tensor or a tuple), computed in
  float64 and rounded to float32 (see the module note)."""
  if isinstance(draws, tuple):
    draws = tuple(_f32(x).double() for x in draws)
  else:
    draws = _f32(draws).double()
  return _f32(fn(draws, *args, **kwargs))


class ChaseTagField:
  """Quadrant terrain: each quadrant FLAT, HILLY, ROUGH or RELIEF, drawn
  per env."""

  def __init__(self, nrow: int, ncol: int, rough_amplitude=0.15,
               hills_amplitude=0.3, relief_amplitude=0.4):
    self.shape = (nrow, ncol)
    self.amps = (rough_amplitude, hills_amplitude, relief_amplitude)

  def draw(self, batch: int, generator, device, dtype) -> dict:
    """Per quadrant (axis 1, four of them): its type in 0..3 and the
    draws of each generator."""
    qshape = (self.shape[0] // 2, self.shape[1] // 2)
    quads = [dict(hilly=draw_hilly(batch, generator, device, dtype),
                  rough=draw_rough(batch, qshape, generator, device, dtype),
                  relief=draw_relief(batch, qshape, generator, device,
                                     dtype))
             for _ in range(4)]
    pick = torch.floor(uniform((batch, 4), generator, device, torch.float64,
                               0, 4)).to(torch.long)
    stack = lambda xs: torch.stack(xs, 1)
    return dict(
        pick=pick,
        hilly=tuple(stack([q["hilly"][i] for q in quads]) for i in range(3)),
        rough=stack([q["rough"] for q in quads]),
        relief=tuple(stack([q["relief"][i] for q in quads])
                     for i in range(3)))

  def from_draws(self, draws: dict) -> torch.Tensor:
    """The fields [B, nrow * ncol], float32."""
    nrow, ncol = self.shape
    hr, hc = nrow // 2, ncol // 2
    rough_amp, hills_amp, relief_amp = self.amps
    quads = []
    for i in range(4):
      rough = _as32(rough_from_draws, draws["rough"][:, i], rough_amp)
      variants = torch.stack([
          torch.zeros_like(rough),
          _as32(hilly_from_draws, tuple(x[:, i] for x in draws["hilly"]),
                (hr, hc), amplitude=hills_amp),
          rough,
          _as32(relief_from_draws, tuple(x[:, i] for x in draws["relief"]),
                (hr, hc), relief_amp)], 1)
      B = variants.shape[0]
      quads.append(variants[torch.arange(B, device=variants.device),
                            draws["pick"][:, i]])
    top = torch.cat([quads[0], quads[1]], dim=2)
    bot = torch.cat([quads[2], quads[3]], dim=2)
    field = torch.cat([top, bot], dim=1)
    out = field.new_zeros((field.shape[0], nrow, ncol))
    out[:, :2 * hr, :2 * hc] = field
    return out.reshape(field.shape[0], -1)


class TrackField:
  """Per-segment difficulty track: rough, hilly or stair sections, each
  steeper than the one before."""

  def __init__(self, nrow: int, ncol: int, n_segments: int = 4):
    self.shape = (nrow, ncol)
    self.n_segments = n_segments

  def draw(self, batch: int, generator, device, dtype) -> dict:
    """Per segment (axis 1): its type in 0..2 and each generator's draws."""
    sshape = (self.shape[0] // self.n_segments, self.shape[1])
    segs = [dict(rough=draw_rough(batch, sshape, generator, device, dtype),
                 hilly=draw_hilly(batch, generator, device, dtype),
                 stairs=draw_stairs(batch, generator, device, dtype))
            for _ in range(self.n_segments)]
    pick = torch.floor(uniform((batch, self.n_segments), generator, device,
                               torch.float64, 0, 3)).to(torch.long)
    stack = lambda xs: torch.stack(xs, 1)
    return dict(
        pick=pick, rough=stack([s["rough"] for s in segs]),
        hilly=tuple(stack([s["hilly"][i] for s in segs]) for i in range(3)),
        stairs=stack([s["stairs"] for s in segs]))

  def from_draws(self, draws: dict, difficulty: float = 1.0) -> torch.Tensor:
    """The fields [B, nrow * ncol], float32."""
    nrow, ncol = self.shape
    sshape = (nrow // self.n_segments, ncol)
    segs = []
    for i in range(self.n_segments):
      amp = difficulty * (i + 1) / self.n_segments
      variants = torch.stack([
          _as32(rough_from_draws, draws["rough"][:, i], 0.3 * amp),
          _as32(hilly_from_draws, tuple(x[:, i] for x in draws["hilly"]),
                sshape, amplitude=0.6 * amp),
          _as32(stairs_from_draws, draws["stairs"][:, i], sshape, amp)], 1)
      B = variants.shape[0]
      segs.append(variants[torch.arange(B, device=variants.device),
                           draws["pick"][:, i]])
    field = torch.cat(segs, dim=1)
    out = field.new_zeros((field.shape[0], nrow, ncol))
    out[:, :field.shape[1]] = field
    return out.reshape(field.shape[0], -1)


class ChallengeTrackField:
  """The run-track challenge's terrain, patch by patch.

  Stairs are 3 ascending and 3 descending flats of the patch's difficulty
  height; hilly is one sine bump normalized over the patch; rough is
  uniform noise normalized over the patch and scaled by U(0, difficulty).
  The difficulty schedules are reversed at construction (rows run against
  the walking direction). ``reset_type``: "flat", "random" (one terrain
  type per episode) or "random_mixed" (a type per patch). The type codes
  are the run-track task's.
  """

  FLAT, HILLY, ROUGH, STAIRS, MIXED = 0, 1, 2, 3, 4

  def __init__(self, nrow: int, ncol: int, rough_difficulties,
               hills_difficulties, stairs_difficulties,
               reset_type: str = "random"):
    self.shape = (nrow, ncol)
    self.rough_d = np.asarray(rough_difficulties[::-1], np.float64)
    self.hills_d = np.asarray(hills_difficulties[::-1], np.float64)
    self.stairs_d = np.asarray(stairs_difficulties[::-1], np.float64)
    self.reset_type = reset_type

  def _patch_bounds(self, n_patches: int):
    nrow = self.shape[0]
    starts = np.arange(0, nrow, nrow // n_patches)
    return [(int(starts[i]), int(starts[i + 1]))
            for i in range(len(starts) - 1)]

  def _stairs_patch(self, lo, hi, h, like):
    length = hi - lo
    flat_len = length // 6
    levels = np.repeat([0.0, 1.0, 2.0, 3.0, 2.0, 1.0], flat_len)
    heights = np.concatenate([levels, np.zeros(length - 6 * flat_len)]) * h
    return like.new_tensor(heights)[:, None].expand(length, self.shape[1])

  def _hilly_patch(self, lo, hi, scalar, like):
    length = hi - lo
    ncol = self.shape[1]
    data = torch.sin(torch.linspace(0.0, math.pi, length * ncol,
                                    dtype=like.dtype, device=like.device))
    data = (data - data.min()) / torch.clamp(data.max() - data.min(),
                                             min=1e-12)
    return torch.flip(data.reshape(length, ncol) * scalar, (0, 1))

  def draw(self, batch: int, generator, device, dtype) -> dict:
    """The type pick ([B], or [B, patches] for "random_mixed") and, per
    rough patch, the fill U(-1, 1) [B, length, ncol] and the scale
    U(0, difficulty) [B]."""
    if self.reset_type == "flat":
      return {}
    bounds = self._patch_bounds(len(self.rough_d))
    fill = [uniform((batch, hi - lo, self.shape[1]), generator, device,
                    dtype, -1.0, 1.0) for lo, hi in bounds]
    scale = [uniform((batch,), generator, device, dtype, 0.0,
                     float(self.rough_d[i])) for i in range(len(bounds))]
    n_pick = ((batch, len(self._patch_bounds(len(self.stairs_d))))
              if self.reset_type == "random_mixed" else (batch,))
    pick = torch.floor(uniform(n_pick, generator, device, torch.float64,
                               0, 3)).to(torch.long)
    return dict(pick=pick, rough_fill=fill, rough_scale=scale)

  def from_draws(self, draws: dict, batch: int, device="cuda",
                 dtype=torch.float32):
    """(the fields [B, nrow * ncol], the type codes [B])."""
    nrow, ncol = self.shape
    if self.reset_type == "flat":
      return (torch.zeros((batch, nrow * ncol), dtype=dtype, device=device),
              torch.full((batch,), self.FLAT, dtype=torch.int32,
                         device=device))
    like = torch.zeros((), dtype=dtype, device=device)
    fields = []
    for kind, d in enumerate((self.stairs_d, self.hills_d, self.rough_d)):
      out = like.new_zeros((batch, nrow, ncol))
      for i, (lo, hi) in enumerate(self._patch_bounds(len(d))):
        if kind == 0:
          out[:, lo:hi] = self._stairs_patch(lo, hi, float(d[i]), like)
        elif kind == 1:
          out[:, lo:hi] = self._hilly_patch(lo, hi, float(d[i]), like)
        else:
          fill = draws["rough_fill"][i]
          lo_v = fill.amin((1, 2), keepdim=True)
          hi_v = fill.amax((1, 2), keepdim=True)
          fill = (fill - lo_v) / torch.clamp(hi_v - lo_v, min=1e-12)
          out[:, lo:hi] = fill * draws["rough_scale"][i][:, None, None]
      fields.append(out)
    fields = torch.stack(fields, 1)                  # [B, 3, nrow, ncol]
    rows = torch.arange(batch, device=device)
    if self.reset_type == "random_mixed":
      out = like.new_zeros((batch, nrow, ncol))
      for i, (lo, hi) in enumerate(self._patch_bounds(len(self.stairs_d))):
        out[:, lo:hi] = fields[rows, draws["pick"][:, i], lo:hi]
      return (out.reshape(batch, -1),
              torch.full((batch,), self.MIXED, dtype=torch.int32,
                         device=device))
    codes = torch.as_tensor([self.STAIRS, self.HILLY, self.ROUGH],
                            dtype=torch.int32, device=device)
    return (fields[rows, draws["pick"]].reshape(batch, -1),
            codes[draws["pick"]])


def local_heightmap(hfield_data: torch.Tensor, nrow: int, ncol: int,
                    size_xy, xy: torch.Tensor, patch=(10, 10)):
  """The grid heights [B, pr, pc] around world positions xy [B, 2] (a
  lookup, no raycast); ``hfield_data`` [nrow * ncol] or [B, nrow * ncol]."""
  B = xy.shape[0]
  data = hfield_data.reshape(-1, nrow, ncol).expand(B, nrow, ncol)
  sx, sy = size_xy
  gx = (xy[:, 0] + sx) / (2 * sx) * (ncol - 1)
  gy = (xy[:, 1] + sy) / (2 * sy) * (nrow - 1)
  pr, pc = patch
  arange = lambda n: torch.arange(n, device=xy.device)
  # a cast to an integer truncates toward zero, as the reference's
  rows = torch.clamp(arange(pr) - pr // 2 + gy.to(torch.int32)[:, None],
                     0, nrow - 1)
  cols = torch.clamp(arange(pc) - pc // 2 + gx.to(torch.int32)[:, None],
                     0, ncol - 1)
  b = arange(B)[:, None, None]
  return data[b, rows[:, :, None], cols[:, None, :]]

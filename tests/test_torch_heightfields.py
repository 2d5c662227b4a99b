"""Terrain generators: the port's ``envs/heightfields.py`` against the JAX
package's, from JAX's own draws.

Each JAX generator draws from a key; the test rebuilds those draws from the
same keys (``jax.random`` calls in the reference's order) and hands them to
the port's ``*_from_draws``. Three keys per case, as a batch.

Tolerances: the plain generators run in float64 on both sides (rtol 1e-12:
one formula, rounding only). ``ChaseTagField`` and ``TrackField`` return
float32 fields whatever the env's dtype, as the reference does; the
reference computes them in float32, the port in float64 rounded once to
float32 (so that the card and the CPU agree bit for bit): they agree
within an ulp, so rtol 1e-6 of the field's largest height.
``ChallengeTrackField`` takes its dtype (float64 here).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, bare_envs_package
from myosuite_mjx_tpu_torch.envs import heightfields as hf

with bare_envs_package():   # the JAX envs package registers asset ids
  from myosuite_mjx_tpu.envs import heightfields as jhf

EXACT = dict(rtol=1e-12, atol=1e-14)
F32 = 1e-6
SHAPE = (12, 18)
KEYS = jax.random.split(jax.random.PRNGKey(5), 3)
F64 = jnp.float64


def _t(x):
  return torch.as_tensor(np.array(x))


def _batch(fn):
  """fn(key) over the three keys, stacked (numpy, leading batch axis)."""
  return jax.tree.map(lambda *xs: np.stack(xs),
                      *[jax.tree.map(np.asarray, fn(k)) for k in KEYS])


def _hilly_draws(k, dtype):
  k1, k2, k3 = jax.random.split(k, 3)
  return (jax.random.uniform(k1, (), dtype, 0, 2 * jnp.pi),
          jax.random.uniform(k2, (), dtype, 0, 2 * jnp.pi),
          jax.random.uniform(k3, (2,), dtype, 0.5, 1.5))


def _relief_draws(k, shape, dtype, n=8):
  k1, k2, k3 = jax.random.split(k, 3)
  return (jax.random.uniform(k1, (n,), dtype, 0, shape[0]),
          jax.random.uniform(k2, (n,), dtype, 0, shape[1]),
          jax.random.uniform(k3, (n,), dtype, 1.0, float(min(shape)) / 6))


def test_flat():
  out = hf.flat(3, SHAPE, torch.float64, "cpu")
  assert out.shape == (3,) + SHAPE and not out.any()
  assert np.asarray(jhf.flat(SHAPE)).sum() == 0


@pytest.mark.parametrize("gen", ("rough", "hilly", "relief", "stairs"))
def test_generator_matches_jax(gen):
  amp = 0.7
  if gen == "rough":
    ref = _batch(lambda k: jhf.rough(k, SHAPE, amp, F64))
    u = _batch(lambda k: jax.random.uniform(k, SHAPE, F64))
    out = hf.rough_from_draws(_t(u), amp)
  elif gen == "hilly":
    ref = _batch(lambda k: jhf.hilly(k, SHAPE, amplitude=amp, dtype=F64))
    draws = _batch(lambda k: _hilly_draws(k, F64))
    out = hf.hilly_from_draws(tuple(map(_t, draws)), SHAPE, amplitude=amp)
  elif gen == "relief":
    ref = _batch(lambda k: jhf.relief(k, SHAPE, amplitude=amp, dtype=F64))
    draws = _batch(lambda k: _relief_draws(k, SHAPE, F64))
    out = hf.relief_from_draws(tuple(map(_t, draws)), SHAPE, amp)
  else:
    ref = _batch(lambda k: jhf.stairs(k, SHAPE, amplitude=amp, dtype=F64))
    u = _batch(lambda k: jax.random.uniform(k, (8,), F64, 0.3, 1.0))
    out = hf.stairs_from_draws(_t(u), SHAPE, amp)
  assert out.shape == (3,) + SHAPE and out.dtype == torch.float64
  assert_close(out, ref, what=gen, **EXACT)


def test_draw_shapes_and_ranges():
  g = torch.Generator().manual_seed(0)
  p1, p2, w = hf.draw_hilly(4, g, "cpu", torch.float64)
  assert p1.shape == (4,) and w.shape == (4, 2)
  assert (w >= 0.5).all() and (w <= 1.5).all()
  cy, cx, sig = hf.draw_relief(4, SHAPE, g, "cpu", torch.float64)
  assert cy.shape == (4, 8) and (cy <= SHAPE[0]).all()
  assert (sig >= 1.0).all() and (sig <= min(SHAPE) / 6).all()
  u = hf.draw_stairs(4, g, "cpu", torch.float64)
  assert (u >= 0.3).all() and (u <= 1.0).all()


def _close32(out, ref, what):
  ref = np.asarray(ref)
  assert out.dtype == torch.float32
  assert_close(out, ref, rtol=0, atol=F32 * np.abs(ref).max(), what=what)


def test_chasetag_field_matches_jax():
  nrow, ncol = 21, 17   # odd: the last row and column stay zero
  amps = dict(rough_amplitude=0.1, hills_amplitude=0.23,
              relief_amplitude=0.3)
  jf = jhf.ChaseTagField(nrow, ncol, **amps)
  ref = _batch(jf.generate)
  qshape = (nrow // 2, ncol // 2)

  def draws(k):
    keys = jax.random.split(k, 8)
    quads = []
    for i in range(4):
      k_type, k_gen = keys[2 * i], keys[2 * i + 1]
      quads.append(dict(
          pick=jax.random.randint(k_type, (), 0, 4),
          hilly=_hilly_draws(k_gen, jnp.float32),
          rough=jax.random.uniform(k_gen, qshape, jnp.float32),
          relief=_relief_draws(k_gen, qshape, jnp.float32)))
    return jax.tree.map(lambda *xs: jnp.stack(xs), *quads)

  d = _batch(draws)
  port = hf.ChaseTagField(nrow, ncol, **amps).from_draws(dict(
      pick=_t(d["pick"]).long(), hilly=tuple(map(_t, d["hilly"])),
      rough=_t(d["rough"]), relief=tuple(map(_t, d["relief"]))))
  assert port.shape == (3, nrow * ncol)
  _close32(port, ref, "chasetag")
  assert len({tuple(p) for p in np.asarray(d["pick"])}) > 1


def test_chasetag_field_draw_runs():
  f = hf.ChaseTagField(20, 20, 0.1, 0.2, 0.3)
  g = torch.Generator().manual_seed(1)
  out = f.from_draws(f.draw(5, g, "cpu", torch.float64))
  assert out.shape == (5, 400) and torch.isfinite(out).all()
  assert (out >= 0).all() and (out <= 0.3 + 1e-6).all()


@pytest.mark.parametrize("difficulty", (0.2, 1.0))
def test_track_field_matches_jax(difficulty):
  nrow, ncol, S = 48, 16, 4
  jf = jhf.TrackField(nrow, ncol, S)
  ref = _batch(lambda k: jf.generate(k, difficulty=difficulty))
  sshape = (nrow // S, ncol)

  def draws(k):
    keys = jax.random.split(k, 2 * S)
    segs = []
    for i in range(S):
      k_type, k_gen = keys[2 * i], keys[2 * i + 1]
      segs.append(dict(
          pick=jax.random.randint(k_type, (), 0, 3),
          rough=jax.random.uniform(k_gen, sshape, jnp.float32),
          hilly=_hilly_draws(k_gen, jnp.float32),
          stairs=jax.random.uniform(k_gen, (8,), jnp.float32, 0.3, 1.0)))
    return jax.tree.map(lambda *xs: jnp.stack(xs), *segs)

  d = _batch(draws)
  port = hf.TrackField(nrow, ncol, S).from_draws(dict(
      pick=_t(d["pick"]).long(), rough=_t(d["rough"]),
      hilly=tuple(map(_t, d["hilly"])), stairs=_t(d["stairs"])), difficulty)
  _close32(port, ref, "track")
  g = torch.Generator().manual_seed(2)
  f = hf.TrackField(nrow, ncol, S)
  assert f.from_draws(f.draw(2, g, "cpu", torch.float64)).shape == (
      2, nrow * ncol)


@pytest.mark.parametrize("mode", ("flat", "random", "random_mixed"))
def test_challenge_track_field_matches_jax(mode):
  nrow, ncol = 60, 10
  diffs = dict(rough_difficulties=(0.05, 0.1, 0.15, 0.2),
               hills_difficulties=(0.3, 0.4, 0.5, 0.6),
               stairs_difficulties=(0.02, 0.04, 0.06, 0.08))
  jf = jhf.ChallengeTrackField(nrow, ncol, reset_type=mode, **diffs)
  pf = hf.ChallengeTrackField(nrow, ncol, reset_type=mode, **diffs)
  ref = _batch(lambda k: jf.generate(k, F64))
  bounds = jf._patch_bounds(len(jf.rough_d))

  def draws(k):
    k_type, k_gen = jax.random.split(k)
    key = jax.random.fold_in(k_gen, 2)
    fill, scale = [], []
    for i, (lo, hi) in enumerate(bounds):
      k1, k2 = jax.random.split(jax.random.fold_in(key, i))
      fill.append(jax.random.uniform(k1, (hi - lo, ncol), F64, -1.0, 1.0))
      scale.append(jax.random.uniform(k2, (), F64, 0.0,
                                      float(jf.rough_d[i])))
    n = len(jf._patch_bounds(len(jf.stairs_d)))
    pick = jax.random.randint(k_type, (n,) if mode == "random_mixed" else (),
                              0, 3)
    return dict(pick=pick, rough_fill=fill, rough_scale=scale)

  if mode == "flat":
    d = {}
  else:
    raw = _batch(draws)
    d = dict(pick=_t(raw["pick"]).long(),
             rough_fill=[_t(x) for x in raw["rough_fill"]],
             rough_scale=[_t(x) for x in raw["rough_scale"]])
  field, code = pf.from_draws(d, 3, "cpu", torch.float64)
  assert_close(field, ref[0], what="field", **EXACT)
  np.testing.assert_array_equal(code.numpy(), ref[1])
  g = torch.Generator().manual_seed(3)
  out, _ = pf.from_draws(pf.draw(2, g, "cpu", torch.float64), 2, "cpu",
                         torch.float64)
  assert out.shape == (2, nrow * ncol) and torch.isfinite(out).all()


def test_local_heightmap_matches_jax():
  rng = np.random.default_rng(0)
  nrow, ncol = 10, 14
  data = rng.uniform(size=(3, nrow * ncol))
  xy = rng.uniform(-1.3, 1.3, (3, 2))
  xy[0] = [0.0, 0.0]
  ref = jax.vmap(lambda d, p: jhf.local_heightmap(
      d, nrow, ncol, (1.0, 0.8), p, patch=(4, 5)))(jnp.asarray(data),
                                                   jnp.asarray(xy))
  out = hf.local_heightmap(_t(data), nrow, ncol, (1.0, 0.8), _t(xy),
                           patch=(4, 5))
  assert out.shape == (3, 4, 5)
  assert_close(out, ref, rtol=0, atol=0)
  shared = hf.local_heightmap(_t(data[0]), nrow, ncol, (1.0, 0.8), _t(xy),
                              patch=(4, 5))
  ref0 = jax.vmap(lambda p: jhf.local_heightmap(
      jnp.asarray(data[0]), nrow, ncol, (1.0, 0.8), p, patch=(4, 5)))(
          jnp.asarray(xy))
  assert_close(shared, ref0, rtol=0, atol=0)

"""The batched SPD solve: the port's plain version against the JAX paths
(the CUDA kernel's own test is tests/test_torch_kernel_gpu.py)."""
from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from test_torch_kernel_gpu import clamp_systems
from torch_parity import (assert_close, jax_batch, jax_model, port_batch,
                          port_model, random_states, to_np)
from myosuite_mjx_tpu.ops import linalg as jlinalg
from myosuite_mjx_tpu.ops import pallas_linalg
from myosuite_mjx_tpu_torch.engine import collision, constraint, forward
from myosuite_mjx_tpu_torch.ops import cuda_linalg, linalg


def _spd(n: int, batch: int, seed: int, dtype=np.float64):
  rng = np.random.default_rng(seed)
  r = rng.normal(size=(batch, n, n))
  a = r @ r.transpose(0, 2, 1) / n + np.eye(n)
  b = rng.normal(size=(batch, n))
  return a.astype(dtype), b.astype(dtype)


def _jax_unrolled(a, b):
  """JAX's unrolled route (chol_factor, cho_solve) under vmap: (x, L)."""
  x = jax.vmap(lambda ai, bi: jlinalg.cho_solve(jlinalg.chol_factor(ai),
                                                bi))(a, b)
  return np.asarray(x), np.asarray(jax.vmap(jlinalg.chol_factor)(a))


@pytest.mark.parametrize("n", [1, 4, 8, 9, 16, 17, 23, 24, 25, 32, 33, 48, 49,
                               64, 65, 72])
def test_plain_matches_jax_unrolled_float64(n):
  a, b = _spd(n, 64, seed=n)
  ref = jax.vmap(jlinalg.spd_solve)(a, b)
  x, L = linalg.spd_solve(torch.as_tensor(a), torch.as_tensor(b), factor=True)
  # same unrolled factor and substitutions, same order: rounding only
  assert_close(x, ref, rtol=1e-12, atol=1e-13, what="x")
  assert_close(L, jax.vmap(jlinalg.chol_factor)(a), rtol=1e-12, atol=1e-13,
               what="L")


@pytest.mark.parametrize("n", [65, 72])
def test_plain_matches_jax_unrolled_float32(n):
  """Above the Pallas gate (n > 64) JAX takes the unrolled route in float32
  too, as the general kernel's shared-tile route does."""
  a, b = _spd(n, 32, seed=200 + n, dtype=np.float32)
  ref, ref_L = _jax_unrolled(a, b)
  x, L = linalg.spd_solve(torch.as_tensor(a), torch.as_tensor(b), factor=True)
  assert x.dtype == torch.float32
  # the same operations in the same order; XLA may contract a multiply and
  # a subtraction that PyTorch rounds apart: a few ulps of the scale
  assert_close(x, ref, rtol=0, atol=2e-5 * np.abs(ref).max(), what="x")
  assert_close(L, ref_L, rtol=0, atol=2e-5 * np.abs(ref_L).max(), what="L")


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("n", [1, 2, 8, 23])
def test_clamp_matches_jax(n, dtype):
  """Pivots that reach 0 (rank-deficient PSD) or go below tiny (slightly
  indefinite): L_jj = a_jj / sqrt(tiny) there, as JAX's chol_factor; x the
  same, NaN and infinite where JAX's is."""
  a, b, piv = clamp_systems(n, dtype, seed=n)
  ref, ref_L = _jax_unrolled(a, b)
  x, L = linalg.spd_solve(torch.as_tensor(a), torch.as_tensor(b), factor=True)
  x, L = x.numpy(), L.numpy()
  root_tiny = np.sqrt(np.finfo(dtype).tiny)
  for s, (j, ajj) in enumerate(piv):
    assert L[s, j, j] == ref_L[s, j, j] == np.asarray(ajj / root_tiny, dtype)
  np.testing.assert_array_equal(np.isnan(x), np.isnan(ref))
  np.testing.assert_array_equal(np.isposinf(x), np.isposinf(ref))
  np.testing.assert_array_equal(np.isneginf(x), np.isneginf(ref))
  assert np.isfinite(ref).any() and not np.isfinite(ref).all()
  bound = 1e-12 if dtype == np.float64 else 2e-5
  for s in range(len(a)):  # each system against its own scale
    fin = np.isfinite(ref[s])
    if fin.any():
      np.testing.assert_allclose(x[s][fin], ref[s][fin], rtol=0,
                                 atol=bound * np.abs(ref[s][fin]).max())
    np.testing.assert_allclose(L[s], ref_L[s], rtol=0,
                               atol=bound * np.abs(ref_L[s]).max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
@settings(max_examples=30, deadline=None)
@given(n=st.integers(1, 40), pad=st.integers(0, 24),
       seed=st.integers(0, 2 ** 31 - 1))
def test_identity_padding_changes_nothing(dtype, n, pad, seed):
  """Padding a system to n + pad with the identity (as the general kernel's
  register route pads to NP) leaves x and the leading n x n block of L
  exactly as they were; the padding's x is 0 and its factor the identity."""
  a, b = _spd(n, 3, seed)
  a, b = torch.as_tensor(a, dtype=dtype), torch.as_tensor(b, dtype=dtype)
  m = n + pad
  ap = torch.eye(m, dtype=dtype).repeat(3, 1, 1)
  ap[:, :n, :n] = a
  bp = torch.zeros(3, m, dtype=dtype)
  bp[:, :n] = b
  x, L = linalg.spd_solve_plain(a, b, factor=True)
  xp, Lp = linalg.spd_solve_plain(ap, bp, factor=True)
  assert torch.equal(xp[:, :n], x) and torch.equal(Lp[:, :n, :n], L)
  assert torch.equal(xp[:, n:], torch.zeros(3, pad, dtype=dtype))
  assert torch.equal(Lp[:, n:, n:], torch.eye(pad, dtype=dtype).repeat(3, 1, 1))
  assert torch.equal(Lp[:, n:, :n], torch.zeros(3, pad, n, dtype=dtype))


@pytest.mark.parametrize("n,batch", [(4, 1), (4, 1025), (23, 1025)])
def test_plain_matches_pallas_interpret_float32(n, batch):
  a, b = _spd(n, batch, seed=100 + n, dtype=np.float32)
  ref = np.asarray(pallas_linalg.spd_solve_batched(a, b, interpret=True))
  x = linalg.spd_solve(torch.as_tensor(a), torch.as_tensor(b))
  # float32, well-conditioned (eigenvalues >= 1): the two orders of the
  # substitution sums differ by a few ulps of the largest entry
  scale = np.abs(ref).max()
  assert_close(x, ref, rtol=0, atol=2e-5 * scale, what="x")


@functools.lru_cache(maxsize=None)
def _rollout_systems():
  """M, M + h D and a Newton H with active contacts, from hand11 states."""
  jm = jax_model(2)
  pm = port_model(2)
  d = forward.forward(pm, port_batch(jax_batch(jm, *random_states(jm, 8, 5))))
  M = d.qM
  mhd = M + pm.opt.timestep * torch.diag(pm.dof_damping)
  blocks, info = collision.contacts(pm, d)
  assert (info.dist < 0).any()
  J, aref, D, is_eq, _, _ = constraint.make_efc(pm, d, blocks)
  jar = (J @ d.qacc[..., None])[..., 0] - aref
  w = D * (is_eq | (jar < 0))
  assert (w > 0).any()
  H = M + (J.transpose(-1, -2) * w[:, None, :]) @ J
  return {"M": M, "M+hD": mhd, "H": H}, d.qfrc_smooth


@pytest.mark.parametrize("which", ["M", "M+hD", "H"])
def test_plain_on_rollout_matrices(which):
  systems, rhs = _rollout_systems()
  a = systems[which]
  ref = jax.vmap(jlinalg.spd_solve)(to_np(a), to_np(rhs))
  x = linalg.spd_solve(a, rhs)
  # stiff contact rows make H ill-conditioned (cond ~1e8): relative 1e-8
  assert_close(x, ref, rtol=1e-8, atol=1e-10 * np.abs(ref).max(), what=which)
  res = (a @ x[..., None])[..., 0] - rhs
  assert float(res.abs().max()) < 1e-8 * float(rhs.abs().max())


def test_dispatch_by_device():
  a, b = _spd(5, 3, seed=7)
  launches = cuda_linalg.spd_solve_cuda.launches
  x = linalg.spd_solve(torch.as_tensor(a), torch.as_tensor(b))
  assert x.shape == (3, 5)
  assert cuda_linalg.spd_solve_cuda.launches == launches  # CPU: plain only
  with pytest.raises(NotImplementedError):
    linalg.spd_solve(torch.empty((3, 5, 5), device="meta"),
                     torch.empty((3, 5), device="meta"))
  with pytest.raises(ValueError, match="CUDA"):
    cuda_linalg.spd_solve_cuda(torch.as_tensor(a, dtype=torch.float32),
                               torch.as_tensor(b, dtype=torch.float32))

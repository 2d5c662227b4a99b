"""The batched SPD solve: the port's plain version against the JAX paths
(the CUDA kernel's own test is tests/test_torch_kernel_gpu.py)."""
from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("n", [1, 4, 9, 23])
def test_plain_matches_jax_unrolled_float64(n):
  a, b = _spd(n, 64, seed=n)
  ref = jax.vmap(jlinalg.spd_solve)(a, b)
  x, L = linalg.spd_solve(torch.as_tensor(a), torch.as_tensor(b), factor=True)
  # same unrolled factor and substitutions, same order: rounding only
  assert_close(x, ref, rtol=1e-12, atol=1e-13, what="x")
  assert_close(L, jax.vmap(jlinalg.chol_factor)(a), rtol=1e-12, atol=1e-13,
               what="L")


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

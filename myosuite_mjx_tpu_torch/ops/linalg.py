"""Batched tiny-SPD solves: the plain PyTorch version and its dispatch.

Counterpart of ``myosuite_mjx_tpu/ops/linalg.py``. The functions here take
a batch: ``a [B, n, n]``, ``b [B, n]``. ``chol_factor`` is the same
right-looking Cholesky, one rank-1 update per column, with each pivot
clamped at ``finfo(dtype).tiny`` as the JAX CPU path does. The Pallas kernel
(``myosuite_mjx_tpu/ops/pallas_linalg.py``) and the CUDA kernel that
replaces it (``csrc/spd_solve.cu``) clamp at 1e-30 instead; the two differ
only for pivots below 1e-30.

``spd_solve`` is what the engine calls (M^-1 qfrc_smooth, the Newton
step and the implicit-damping integrator). A CPU tensor takes the plain
version. A CUDA tensor goes to the CUDA kernel, which raises on anything it
does not take; there is no fallback between the two.
"""
from __future__ import annotations

import torch

from myosuite_mjx_tpu_torch.ops import cuda_linalg


def chol_factor(a: torch.Tensor) -> torch.Tensor:
  """Lower Cholesky factor of a batch of SPD matrices [B, n, n]."""
  n = a.shape[-1]
  if n == 0:
    return a
  tiny = torch.finfo(a.dtype).tiny
  idx = torch.arange(n, device=a.device)
  resid = a
  cols = []
  for j in range(n):
    d = torch.sqrt(torch.clamp(resid[..., j, j], min=tiny))
    col = torch.where(idx >= j, resid[..., :, j] / d[..., None],
                      torch.zeros((), dtype=a.dtype, device=a.device))
    resid = resid - col[..., :, None] * col[..., None, :]
    cols.append(col)
  return torch.stack(cols, dim=-1)


def solve_lower(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Solve L y = b for lower-triangular L [B, n, n], b [B, n]."""
  n = L.shape[-1]
  if n == 0:
    return b
  idx = torch.arange(n, device=L.device)
  zero = torch.zeros((), dtype=b.dtype, device=b.device)
  resid = b
  ys = []
  for i in range(n):
    yi = resid[..., i] / L[..., i, i]
    resid = resid - yi[..., None] * torch.where(idx > i, L[..., :, i], zero)
    ys.append(yi)
  return torch.stack(ys, dim=-1)


def solve_upper_t(L: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
  """Solve L^T x = y for lower-triangular L [B, n, n], y [B, n]."""
  n = L.shape[-1]
  if n == 0:
    return y
  idx = torch.arange(n, device=L.device)
  zero = torch.zeros((), dtype=y.dtype, device=y.device)
  resid = y
  xs = [None] * n
  for i in range(n - 1, -1, -1):
    xi = resid[..., i] / L[..., i, i]
    resid = resid - xi[..., None] * torch.where(idx < i, L[..., i, :], zero)
    xs[i] = xi
  return torch.stack(xs, dim=-1)


def cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Solve A x = b given the Cholesky factor L of A; b [B, n]."""
  return solve_upper_t(L, solve_lower(L, b))


def spd_solve_plain(a: torch.Tensor, b: torch.Tensor, factor: bool = False):
  """Plain PyTorch SPD solve: factor plus two substitutions.

  With ``factor`` it returns (x, L), L the lower Cholesky factor of a.
  """
  L = chol_factor(a)
  x = cho_solve(L, b)
  return (x, L) if factor else x


def spd_solve(a: torch.Tensor, b: torch.Tensor, factor: bool = False):
  """Solve a[i] x[i] = b[i] for a [B, n, n] SPD batch and b [B, n].

  With ``factor`` it returns (x, L), L the lower Cholesky factor of a (the
  forward pass takes the mass matrix factor ``qLD`` from here).
  """
  if a.device.type == "cpu":
    return spd_solve_plain(a, b, factor)
  if a.device.type == "cuda":
    return cuda_linalg.spd_solve_cuda(a.contiguous(), b.contiguous(), factor)
  raise NotImplementedError(f"spd_solve on device type {a.device.type!r}")

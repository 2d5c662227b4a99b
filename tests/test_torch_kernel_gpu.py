"""The CUDA SPD-solve kernel against its plain PyTorch version, on a card.

Imports no jax, so it runs on the GPU machine too:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_kernel_gpu.py

Without a card every case skips: the kernel has no CPU mode. The sizes
cover every padded size the kernel is built for (8, 16, 24, 32, 64), both
ends of each, and n = 1; the batches cover a single system, whole blocks
(the bulk-copy load) and a ragged last block (the plain load).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from myosuite_mjx_tpu_torch.ops import cuda_linalg, linalg

SIZES = (1, 4, 8, 11, 16, 17, 23, 24, 32, 33, 64)
BATCHES = (1, 1000, 4096, 4097)
# float32 on both sides, other operation order: a few ulps of the scale
BOUND = 2e-5


def _spd(n: int, batch: int, seed: int):
  rng = np.random.default_rng(seed)
  r = rng.normal(size=(batch, n, n))
  a = r @ r.transpose(0, 2, 1) / n + np.eye(n)
  return a.astype(np.float32), rng.normal(size=(batch, n)).astype(np.float32)


def _check_against_plain(ac: torch.Tensor, bc: torch.Tensor):
  before = cuda_linalg.spd_solve_cuda.launches
  x, L = cuda_linalg.spd_solve_cuda(ac, bc, factor=True)
  x_only = cuda_linalg.spd_solve_cuda(ac, bc)
  xp, Lp = linalg.spd_solve_plain(ac, bc, factor=True)
  torch.cuda.synchronize()
  assert cuda_linalg.spd_solve_cuda.launches == before + 2
  assert torch.equal(x, x_only)
  np.testing.assert_allclose(x.cpu().numpy(), xp.cpu().numpy(), rtol=0,
                             atol=BOUND * float(xp.abs().max()))
  np.testing.assert_allclose(L.cpu().numpy(), Lp.cpu().numpy(), rtol=0,
                             atol=BOUND * float(Lp.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("n", SIZES)
def test_kernel_matches_plain_on_card(n, batch):
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the kernel has no CPU mode")
  a, b = _spd(n, batch, seed=n * 10_000 + batch)
  _check_against_plain(torch.as_tensor(a, device="cuda"),
                       torch.as_tensor(b, device="cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [23, 24])
def test_kernel_on_misaligned_view(n):
  """A contiguous view 4 bytes past a 16-byte boundary takes the plain load."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the kernel has no CPU mode")
  batch = 4096
  a, b = _spd(n, batch, seed=n)
  big = torch.empty(batch * n * n + 1, device="cuda")
  ac = big[1:].view(batch, n, n)
  ac.copy_(torch.as_tensor(a))
  assert ac.is_contiguous() and ac.data_ptr() % 16 == 4
  _check_against_plain(ac, torch.as_tensor(b, device="cuda"))


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  a, b = _spd(5, 3, seed=0)
  ac = torch.as_tensor(a, device="cuda")
  bc = torch.as_tensor(b, device="cuda")
  with pytest.raises(TypeError):
    cuda_linalg.spd_solve_cuda(ac.double(), bc.double())
  with pytest.raises(ValueError):
    cuda_linalg.spd_solve_cuda(ac.transpose(1, 2), bc)
  with pytest.raises(ValueError):
    cuda_linalg.spd_solve_cuda(torch.zeros(2, 65, 65, device="cuda"),
                               torch.zeros(2, 65, device="cuda"))

"""The CUDA SPD-solve kernel against its plain PyTorch version, on a card.

Imports no jax, so it runs on the GPU machine too:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_kernel_gpu.py

Without a card every case skips: the kernel has no CPU mode.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from myosuite_mjx_tpu_torch.ops import cuda_linalg, linalg


def _spd(n: int, batch: int, seed: int):
  rng = np.random.default_rng(seed)
  r = rng.normal(size=(batch, n, n))
  a = r @ r.transpose(0, 2, 1) / n + np.eye(n)
  return a.astype(np.float32), rng.normal(size=(batch, n)).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("n,batch", [(1, 3), (4, 1), (23, 4096), (23, 4097),
                                     (64, 1000)])
def test_kernel_matches_plain_on_card(n, batch):
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the kernel has no CPU mode")
  a, b = _spd(n, batch, seed=n)
  ac = torch.as_tensor(a, device="cuda")
  bc = torch.as_tensor(b, device="cuda")
  before = cuda_linalg.spd_solve_cuda.launches
  x, L = cuda_linalg.spd_solve_cuda(ac, bc, factor=True)
  xp, Lp = linalg.spd_solve_plain(ac, bc, factor=True)
  torch.cuda.synchronize()
  assert cuda_linalg.spd_solve_cuda.launches == before + 1
  # float32 on both sides, other operation order: a few ulps of the scale
  np.testing.assert_allclose(x.cpu().numpy(), xp.cpu().numpy(), rtol=0,
                             atol=2e-5 * float(xp.abs().max()))
  np.testing.assert_allclose(L.cpu().numpy(), Lp.cpu().numpy(), rtol=0,
                             atol=2e-5 * float(Lp.abs().max()))


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

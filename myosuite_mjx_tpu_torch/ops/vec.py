"""Vector helpers of the engine's stages, over the last dimension and
broadcast over the leading ones."""
from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  return (a * b).sum(-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  a, b = torch.broadcast_tensors(a, b)
  return torch.linalg.cross(a, b, dim=-1)


def norm(x: torch.Tensor) -> torch.Tensor:
  return torch.linalg.vector_norm(x, dim=-1)


def mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
  """Batched matrix-vector product [..., m, n] x [..., n] -> [..., m], as a
  matmul."""
  return (A @ x[..., None])[..., 0]

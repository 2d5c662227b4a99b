"""The control's precision: TF32, the nearest below float32 with TF32 off.

A TF32 tensor-core product rounds both operands to a 10-bit mantissa and
accumulates in float32. cuBLAS takes its TF32 kernels only where its
heuristics choose them, and for the batched products of one env's small
matrices it chooses FFMA kernels, which the TF32 switch leaves as they
are. So the control both turns the switch on and rounds the float32
operands of every ``@``, ``matmul``, ``bmm`` and ``einsum`` to TF32, as a
TF32 kernel does, whatever kernel then runs. Gradients pass the rounding
unchanged.
"""
from __future__ import annotations

import contextlib

import torch


def to_tf32(x):
  """``x`` with a float32 tensor's mantissa rounded to 10 bits (nearest,
  ties away from zero), as a TF32 operand."""
  if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
    return x
  bits = x.detach().contiguous().view(torch.int32)
  r = ((bits + 0x1000) & -0x2000).view(torch.float32)
  return x + (r - x).detach() if x.requires_grad else r


@contextlib.contextmanager
def tf32():
  """Inside: the TF32 switch on and every float32 product's operands
  rounded to TF32."""
  saved = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
  funcs = (torch.Tensor.__matmul__, torch.Tensor.__rmatmul__, torch.matmul,
           torch.bmm, torch.einsum)
  mm, rmm, matmul, bmm, einsum = funcs
  torch.backends.cuda.matmul.allow_tf32 = True
  torch.backends.cudnn.allow_tf32 = True
  torch.set_float32_matmul_precision("high")
  torch.Tensor.__matmul__ = lambda a, b: mm(to_tf32(a), to_tf32(b))
  torch.Tensor.__rmatmul__ = lambda a, b: rmm(to_tf32(a), to_tf32(b))
  torch.matmul = lambda a, b, **kw: matmul(to_tf32(a), to_tf32(b), **kw)
  torch.bmm = lambda a, b, **kw: bmm(to_tf32(a), to_tf32(b), **kw)

  def _einsum(eq, *ops):
    if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
      ops = ops[0]
    return einsum(eq, *[to_tf32(o) for o in ops])

  torch.einsum = _einsum
  try:
    yield
  finally:
    (torch.Tensor.__matmul__, torch.Tensor.__rmatmul__, torch.matmul,
     torch.bmm, torch.einsum) = funcs
    torch.backends.cuda.matmul.allow_tf32 = saved[0]
    torch.backends.cudnn.allow_tf32 = saved[1]
    torch.set_float32_matmul_precision(saved[2])

"""The few device calls the loops make, which are no-ops on the CPU (where
the benchmark's tests drive the loops at a tiny size)."""
from __future__ import annotations

import torch


def sync(dev: torch.device) -> None:
  if dev.type == "cuda":
    torch.cuda.synchronize(dev)


def memory_peak(dev: torch.device) -> int:
  return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def release(dev: torch.device) -> None:
  if dev.type == "cuda":
    torch.cuda.empty_cache()

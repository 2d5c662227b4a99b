"""Training metrics sinks and divergence guard.

Counterpart of ``myosuite_mjx_tpu/train/metrics.py``: an append-only jsonl
writer plus a tensorboard event stream when ``torch.utils.tensorboard``
imports (the JAX package uses ``tensorboardX``); both record the
per-iteration metric dicts the trainers emit. A logging sink on the host,
not the device path.
"""
from __future__ import annotations

import json
import math
import os
import time
from typing import IO


class DivergenceError(RuntimeError):
  """Raised when training produces non-finite losses/params."""


def check_finite(metrics: dict, where: str = "train_step") -> None:
  """Raise DivergenceError if any scalar metric is NaN/Inf.

  The trainers call this on the host-side metric dict each iteration, after
  the one device-to-host copy of the metrics.
  """
  bad = {k: v for k, v in metrics.items()
         if isinstance(v, (int, float)) and not math.isfinite(v)}
  if bad:
    raise DivergenceError(f"non-finite metrics in {where}: {bad}")


class MetricsWriter:
  """Append-only metrics sink: jsonl always, tensorboard if available.

  Usage:
      w = MetricsWriter(logdir)
      w.write(step, {"loss": 0.3, "reward_mean": 1.2})
      w.close()
  """

  def __init__(self, logdir: str, tensorboard: bool = True,
               truncate_after: int | None = None):
    """``truncate_after``: on resume, drop existing metrics.jsonl records
    with a step beyond the resume point before appending, so the file stays
    a single monotonic history."""
    self.logdir = logdir
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "metrics.jsonl")
    if truncate_after is not None and os.path.exists(path):
      with open(path) as f:
        keep = [ln for ln in f
                if ln.strip()
                and json.loads(ln).get("step", 0) <= truncate_after]
      with open(path, "w") as f:
        f.writelines(keep)
    self._jsonl: IO = open(path, "a")
    self._tb = None
    if tensorboard:
      try:
        from torch.utils.tensorboard import SummaryWriter
      except ImportError:   # no tensorboard package: jsonl alone
        SummaryWriter = None
      if SummaryWriter is not None:
        self._tb = SummaryWriter(log_dir=logdir)
    self._t0 = time.time()

  def write(self, step: int, metrics: dict) -> None:
    rec = {"step": int(step), "wall": round(time.time() - self._t0, 3)}
    for k, v in metrics.items():
      try:
        rec[k] = float(v)
      except (TypeError, ValueError):
        rec[k] = v
    self._jsonl.write(json.dumps(rec) + "\n")
    self._jsonl.flush()
    if self._tb is not None:
      for k, v in rec.items():
        if k != "step" and isinstance(v, float):
          self._tb.add_scalar(k, v, int(step))

  def close(self) -> None:
    self._jsonl.close()
    if self._tb is not None:
      self._tb.close()

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()

"""Read a ``torch.profiler`` trace of the measured window.

``Window`` wraps the profiler around the loop and, once it has stopped,
reduces the raw events to what the per-layer readers and the result's
``breakdown`` take: the device's busy time (the union of kernel, memcpy and
memset intervals), the kernels launched, device time by kernel name, and
the device's idle gaps named by the outermost host op running in each.
"""
from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark.harness import device

_WINDOW = "benchmark.window"


def _raw_events(prof):
  """(name, kind, start_ns, end_ns) of every event from the kineto results
  (no tree is built), kind one of ``kernel``, ``copy`` (device memcpy and
  memset), ``host`` (an op or annotation on the host) or ``other`` (a
  device-side copy of a host annotation, which carries a host op's name)."""
  cuda = torch.autograd.DeviceType.CUDA
  raw = [(e.name(), e.device_type() == cuda, e.start_ns(),
          e.start_ns() + e.duration_ns())
         for e in prof.profiler.kineto_results.events()]
  host_names = {n for n, on_dev, _, _ in raw if not on_dev}

  def kind(name: str, on_dev: bool) -> str:
    if not on_dev:
      return "host"
    if name in host_names:
      return "other"
    return "copy" if name.startswith(("Memcpy", "Memset")) else "kernel"

  return [(n, kind(n, d), s, e) for n, d, s, e in raw]


class Window:
  """``with Window() as w:`` around the traced loop; read ``w.result``."""

  def __init__(self, dev: torch.device):
    self._dev = dev
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
      acts.append(ProfilerActivity.CUDA)
    self._prof = profile(activities=acts)
    self.result: dict | None = None

  def __enter__(self):
    device.sync(self._dev)
    self._prof.__enter__()
    self._mark = record_function(_WINDOW)
    self._mark.__enter__()
    self._t0 = time.perf_counter()
    return self

  def __exit__(self, *exc):
    device.sync(self._dev)
    self.window_s = time.perf_counter() - self._t0
    self._mark.__exit__(*exc)
    self._prof.__exit__(*exc)
    if exc[0] is None:
      self.result = reduce(_raw_events(self._prof), self.window_s)
    return False


def reduce(events: list, window_s: float) -> dict:
  """Busy and idle time, launches, device time by kernel and idle time by
  host op over the window marked by the ``_WINDOW`` annotation."""
  marks = [(s, e) for n, k, s, e in events if n == _WINDOW and k == "host"]
  w0, w1 = marks[0] if marks else (None, None)
  dev = [(n, k, s, e) for n, k, s, e in events if k in ("kernel", "copy")]
  if w0 is not None:
    dev = [(n, k, max(s, w0), min(e, w1)) for n, k, s, e in dev
           if e > w0 and s < w1]
  launches = sum(1 for _, k, _, _ in dev if k == "kernel")
  by_kernel: dict[str, float] = {}
  for n, _, s, e in dev:
    by_kernel[n] = by_kernel.get(n, 0.0) + (e - s) * 1e-9
  busy_ns, gaps = 0, []
  if dev:
    st = np.array([s for _, _, s, _ in dev], dtype=np.int64)
    en = np.array([e for _, _, _, e in dev], dtype=np.int64)
    order = np.argsort(st, kind="stable")
    st, en = st[order], en[order]
    run_end = np.maximum.accumulate(en)
    new = np.ones(len(st), dtype=bool)
    new[1:] = st[1:] > run_end[:-1]
    starts = st[new]
    ends = np.append(run_end[np.nonzero(new)[0][1:] - 1], run_end[-1])
    busy_ns = int((ends - starts).sum())
    lo = w0 if w0 is not None else int(starts[0])
    hi = w1 if w1 is not None else int(ends[-1])
    gap_lo = np.concatenate([[lo], ends])
    gap_hi = np.concatenate([starts, [hi]])
    keep = gap_hi > gap_lo
    gaps = list(zip(gap_lo[keep].tolist(), gap_hi[keep].tolist()))
  return {"busy_s": busy_ns * 1e-9, "window_s": window_s,
          "launches": launches, "kernel_s": by_kernel,
          "idle_by_host_op": _name_gaps(events, gaps, w0, w1)}


def _name_gaps(events: list, gaps: list, w0, w1) -> dict:
  """Idle seconds by the outermost host op that covers each gap's middle
  (``host: no op`` where Python ran between ops)."""
  host = sorted((s, e, n) for n, k, s, e in events
                if k == "host" and n != _WINDOW
                and (w0 is None or (e > w0 and s < w1)))
  top = []          # outermost host intervals, in start order
  for s, e, n in host:
    if top and s < top[-1][1]:
      if e > top[-1][1] and s == top[-1][0]:
        top[-1] = (s, e, n)
      continue
    top.append((s, e, n))
  starts = np.array([t[0] for t in top], dtype=np.int64)
  out: dict[str, float] = {}
  for g0, g1 in gaps:
    mid = (g0 + g1) // 2
    i = int(np.searchsorted(starts, mid, side="right")) - 1
    name = top[i][2] if i >= 0 and top[i][1] >= mid else "host: no op"
    out[name] = out.get(name, 0.0) + (g1 - g0) * 1e-9
  return out


def top(items: dict, k: int = 10) -> list:
  """The ``k`` largest entries as [name, seconds] pairs."""
  return [[n, v] for n, v in sorted(items.items(), key=lambda kv: -kv[1])[:k]]

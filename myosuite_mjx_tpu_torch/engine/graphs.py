"""CUDA-graph replay of the substep's staged code on the card.

The forward (``engine/forward.py``) and the Newton solve
(``engine/solver.py``) each copy their inputs into static buffers kept per
key, and split their work into parts that read and write only those
buffers: the forward's graph A (``fwd_position`` .. ``fwd_acceleration``)
and graph B (contacts and ``make_efc``), the solve's warm-start prologue
and one block. This module owns what both do with those parts:

- ``graphable``: whether a call may replay graphs at all;
- ``Graph``: one part captured, with the kernels' launch counters and the
  span counters' counts carried across replays;
- ``Parts``: the lifecycle of a key's parts. The first run of a part goes
  eagerly on the key's side stream (the warm-up), the next captures it,
  and every later one replays it. Part k > 0 is captured only once part 0
  is, into part 0's pool, so a key has one pool;
- ``Cache``: the staged objects by key, the most recently used kept;
- ``copy_out``: results copied out of static buffers into fresh tensors.

A part's code may open spans (``utils/spans.py``). Outside a profiler they
are no-ops; under one they open only while the part runs eagerly or is
captured, nested inside the span its caller replays it in
(``engine.fwd_position``, ``engine.contacts``, ``engine.newton``), so the
trace's readers, which take the outermost name, read the same. A replay
runs no Python and opens none.
"""
from __future__ import annotations

import torch

from myosuite_mjx_tpu_torch.ops import cuda_linalg
from myosuite_mjx_tpu_torch.utils import spans


def graphable(tensors) -> bool:
  """Whether a call on ``tensors`` may replay graphs: CUDA tensors, none
  requiring grad, and no capture already under way on the current
  stream."""
  return (tensors[0].is_cuda and not any(t.requires_grad for t in tensors)
          and not torch.cuda.is_current_stream_capturing())


# the launch counters of the kernels a graph's code can launch, and the
# span counters' counts it can feed (Python-side: a replay runs no Python)
COUNTERS = (cuda_linalg.spd_solve_cuda, cuda_linalg.spd_solve_general_cuda,
            cuda_linalg.capsule_hull_cuda, spans.capsule_fused,
            spans.capsule_calls)


class Graph:
  """A CUDA graph of ``fn``, captured on ``stream`` into ``pool`` (another
  graph's ``pool()``, or a private one); calling it replays the graph and
  adds the kernel launches and span counts it holds to their counters (the
  capture, which launches nothing, takes its count back)."""

  def __init__(self, fn, stream, pool=None):
    before = [c.launches for c in COUNTERS]
    self.graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                          capture_error_mode="thread_local"):
      fn()
    self.launches = [c.launches - b for c, b in zip(COUNTERS, before)]
    for c, n in zip(COUNTERS, self.launches):
      c.launches -= n

  def __call__(self) -> None:
    self.graph.replay()
    for c, n in zip(COUNTERS, self.launches):
      c.launches += n


class Parts:
  """The graphs of one key's ``n`` parts on ``device``, and the side
  stream they warm up and are captured on (None off the card)."""

  def __init__(self, device: torch.device, n: int):
    self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    self.graphs = [None] * n
    self.warm = [False] * n

  def run(self, part: int, fn) -> bool:
    """Run ``part``, whose code is ``fn``: warm-up, capture or replay (see
    the module's docstring). Says whether it replayed a graph."""
    g = self.graphs[part]
    if (g is None and self.warm[part]
        and (part == 0 or self.graphs[0] is not None)):
      pool = self.graphs[0].graph.pool() if part else None
      g = self.graphs[part] = Graph(fn, self.stream, pool)
    if g is not None:
      g()
      return True
    current = torch.cuda.current_stream(self.stream.device)
    self.stream.wait_stream(current)
    with torch.cuda.stream(self.stream):
      fn()
    current.wait_stream(self.stream)
    self.warm[part] = True
    return False


# keys a cache keeps
KEEP = 8


class Cache:
  """Staged objects by key, the most recently used last; past ``KEEP``
  keys the oldest go, and their graphs with them."""

  def __init__(self):
    self.entries: dict = {}

  def get(self, key, make):
    """The entry of ``key``, made by ``make()`` if there is none."""
    entry = self.entries.pop(key, None)
    if entry is None:
      entry = make()
    self.entries[key] = entry
    while len(self.entries) > KEEP:
      del self.entries[next(iter(self.entries))]
    return entry

  def clear(self) -> None:
    self.entries.clear()


def copy_out(tensors: list) -> list:
  """Fresh copies of contiguous ``tensors``: one ``cat`` a dtype into a
  new buffer, each copy a view of it, so none shares memory with the
  tensors copied."""
  out = list(tensors)
  groups: dict = {}
  for i, t in enumerate(tensors):
    groups.setdefault(t.dtype, []).append(i)
  for idx in groups.values():
    flat = torch.cat([tensors[i].reshape(-1) for i in idx])
    for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
      out[i] = part.view(tensors[i].shape)
  return out

"""The CUDA-graph module's key cache (``engine/graphs.py`` ``Cache``), as
its two users hold it: the forward's and the Newton solve's staged objects
by key. Each keeps the ``KEEP`` most recently used keys, a hit makes
nothing and counts as a use, a new key past ``KEEP`` evicts the least
recently used, and one user's keys never evict the other's.
"""
from __future__ import annotations

import pytest

from myosuite_mjx_tpu_torch.engine import forward, graphs, solver

USERS = {"forward": forward.staged, "solver": solver.staged}


@pytest.mark.parametrize("user", sorted(USERS))
def test_cache_keeps_the_most_recently_used_keys_per_user(user, monkeypatch):
  for cache in USERS.values():
    monkeypatch.setattr(cache, "entries", {})
  cache = USERS[user]
  (other,) = [c for n, c in USERS.items() if n != user]
  other.get("other", lambda: "kept")
  made = []

  def make(key):
    return lambda: made.append(key) or f"entry {key}"

  for key in range(graphs.KEEP):
    assert cache.get(key, make(key)) == f"entry {key}"
  assert cache.get(0, make(0)) == "entry 0"
  assert made == list(range(graphs.KEEP))
  cache.get(graphs.KEEP, make(graphs.KEEP))
  assert list(cache.entries) == (list(range(2, graphs.KEEP))
                                 + [0, graphs.KEEP])
  assert other.entries == {"other": "kept"}
  cache.clear()
  assert not cache.entries and other.entries == {"other": "kept"}

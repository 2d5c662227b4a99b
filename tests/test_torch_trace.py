"""The rollout trace (``logger/trace.py``): the port against the JAX module.

The JAX package's round trip (``tests/test_logger.py``) runs on the port in
both formats; files written by either package load in the other with the
same groups and values (exact); tensors (any device) are copied to the
host when appended; a batched rollout splits into the same groups as
JAX's; ``verify`` flags ragged horizons; ``render`` writes a video of
rgb frames through ``imageio``.
"""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from myosuite_mjx_tpu.logger.trace import Trace as JTrace
from myosuite_mjx_tpu_torch.logger.trace import Trace


def _fill(t, seed: int = 0):
  rng = np.random.default_rng(seed)
  for ep in range(2):
    for i in range(5):
      t.append_datums(f"Trial{ep}", obs=rng.normal(size=3) + i,
                      rew=float(i), done=bool(i == 4))
  return t


def _assert_same(a, b):
  assert a.name == b.name and sorted(a.trace) == sorted(b.trace)
  for g in a.trace:
    assert sorted(a.trace[g]) == sorted(b.trace[g])
    for k in a.trace[g]:
      np.testing.assert_array_equal(np.asarray(a.trace[g][k]),
                                    np.asarray(b.trace[g][k]))


def test_trace_roundtrip(tmp_path):
  t = Trace("test")
  for ep in range(2):
    for i in range(5):
      t.append_datums(f"Trial{ep}", obs=np.arange(3) + i, rew=float(i))
  assert t.verify()
  t.stack()
  assert t.trace["Trial0"]["obs"].shape == (5, 3)
  for ext in ("h5", "pkl"):
    p = str(tmp_path / f"trace.{ext}")
    t.save(p)
    t2 = Trace.load(p)
    np.testing.assert_allclose(np.asarray(t2.trace["Trial1"]["obs"]),
                               t.trace["Trial1"]["obs"])


@pytest.mark.parametrize("ext", ["h5", "pkl"])
def test_files_cross_load_between_packages(tmp_path, ext):
  port, ref = _fill(Trace("cross")), _fill(JTrace("cross"))
  port.stack()
  ref.stack()
  _assert_same(port, ref)
  port.save(str(tmp_path / f"port.{ext}"))
  ref.save(str(tmp_path / f"ref.{ext}"))
  _assert_same(JTrace.load(str(tmp_path / f"port.{ext}")), ref)
  _assert_same(Trace.load(str(tmp_path / f"ref.{ext}")), port)


def test_tensors_are_copied_to_the_host():
  t = Trace()
  t.append_datum("g", "x", torch.arange(3.0))
  t.create_dataset("g", "y", torch.ones(2, dtype=torch.float64))
  t.append_datums("g", z=torch.tensor(True))
  assert all(isinstance(v[0], np.ndarray) for v in t.trace["g"].values())
  np.testing.assert_array_equal(t.trace["g"]["x"][0], [0.0, 1.0, 2.0])


def test_batched_rollout_matches_jax():
  rng = np.random.default_rng(1)
  stacked = dict(obs=rng.normal(size=(6, 3, 4)), rew=rng.normal(size=(6, 3)))
  port, ref = Trace("b"), JTrace("b")
  port.append_batched_rollout("env", obs=torch.as_tensor(stacked["obs"]),
                              rew=stacked["rew"])
  ref.append_batched_rollout("env", **stacked)
  port.stack()
  ref.stack()
  _assert_same(port, ref)
  assert sorted(port.trace) == ["env0", "env1", "env2"]
  assert port.trace["env1"]["obs"].shape == (6, 4)
  assert port.flatten().keys() == ref.flatten().keys()


def test_verify_save_errors_and_repr(tmp_path):
  t = Trace("v")
  t.append_datums("g", a=1.0, b=2.0)
  t.append_datum("g", "a", 3.0)
  assert not t.verify()
  with pytest.raises(ValueError):
    t.save(str(tmp_path / "v.pkl"))
  t.save(str(tmp_path / "v.pkl"), verify=False)
  with pytest.raises(ValueError):
    t.save(str(tmp_path / "v.txt"), verify=False)
  with pytest.raises(ValueError):
    Trace.load(str(tmp_path / "v.txt"))
  assert repr(t) == repr(_as_jax(t))


def _as_jax(t):
  j = JTrace(t.name)
  j.trace.update(t.trace)
  return j


def test_render_writes_rgb_frames(tmp_path):
  t = Trace("r")
  rng = np.random.default_rng(2)
  for _ in range(4):
    t.append_datum("g", "rgb", rng.integers(0, 255, (8, 8, 3), np.uint8))
  t.append_datum("h", "rgb", np.zeros((8, 8)))
  paths = t.render(str(tmp_path), groups=["g"])
  assert len(paths) == 1 and os.path.getsize(paths[0]) > 0
  with pytest.raises(ValueError):
    t.render(str(tmp_path), groups=["h"])

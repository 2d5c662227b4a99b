"""The forward pass's staged path (``engine/forward.py`` ``_Staged``), the
code its two CUDA graphs replay on the card, run on the CPU with each
graph's code called in place of a replay.

On hand23 pose and on legs16 walk on MyoLeg's knees (equality and
floor-contact rows), with and without constraints and ``full_data``, the
staged forward gives the eager ``forward``'s Data bit for bit, every
derived field and the contact set included; the tensors it returns share
no memory with its static buffers or with what its graphs write, so a
later call leaves them as they were; a change of B, dtype, model, overlay
entry or ``full_data`` makes a new key; the CPU takes the eager stages;
and the graphed code, once warm, makes no tensor from host data and reads
no device value on the host, neither of which a CUDA graph can capture.
"""
from __future__ import annotations

import dataclasses
import functools
import os

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from myosuite_mjx_tpu_torch import envs
from myosuite_mjx_tpu_torch.engine import forward, graphs

B = 4
ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "myosuite_mjx_tpu_torch", "assets")
SCENES = {"hand23": ("hand23PoseFixed-v0", None),
          "legs16_knee": ("legs16Walk-v0", "legs16_knee.npz")}


def _plain(part, fn) -> bool:
  """The staged path's ``run`` without a card: call the graph's code."""
  fn()
  return False


@functools.lru_cache(maxsize=None)
def _scene(name: str):
  """(model, Data one substep after the reset under random muscle ctrl,
  the Data one substep later)."""
  task, path = SCENES[name]
  kw = {"model_path": os.path.join(ASSETS, path)} if path else {}
  env = envs.make(task, **kw)
  g = torch.Generator().manual_seed(0)
  m = env.device_model("cpu")
  d = env.reset(B, "cpu", g).data
  d = d.replace(ctrl=torch.rand(d.ctrl.shape, generator=g))
  d = forward.step(m, d)
  return m, d, forward.step(m, d)


def _leaves(x, path=""):
  if isinstance(x, torch.Tensor):
    yield path, x
  elif isinstance(x, dict):
    for k in sorted(x):
      yield from _leaves(x[k], f"{path}.{k}")
  elif dataclasses.is_dataclass(x):
    for f in dataclasses.fields(x):
      yield from _leaves(getattr(x, f.name), f"{path}.{f.name}")
  elif isinstance(x, (tuple, list)):
    for i, v in enumerate(x):
      yield from _leaves(v, f"{path}[{i}]")


@pytest.mark.parametrize("full_data", [False, True], ids=["part", "full"])
@pytest.mark.parametrize("constraint", [False, True],
                         ids=["smooth", "constrained"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_staged_forward_matches_eager(scene, constraint, full_data):
  m, d, _ = _scene(scene)
  eager = dict(_leaves(forward.forward(m, d, constraint, full_data)))
  st = forward._Staged(m, d, full_data)
  out, graphed = st.forward(d, constraint, _plain)
  staged = dict(_leaves(out))
  assert not graphed and staged.keys() == eager.keys()
  for k in eager:
    assert torch.equal(staged[k], eager[k]), k
  if scene == "legs16_knee" and constraint and full_data:
    assert int(out.ne_active.sum()) > 0


def _storages(*trees) -> set:
  return {t.untyped_storage().data_ptr() for tree in trees
          for _, t in _leaves(tree) if t.numel()}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_returned_tensors_share_no_memory_with_the_buffers(scene):
  m, d, d2 = _scene(scene)
  st = forward._Staged(m, d, True)
  wrote = []

  def run(part, fn):
    fn()
    wrote.append(st.rows if part else st.after)
    return False

  first, _ = st.forward(d, True, run)
  after, rows = wrote
  kept = {k: t.clone() for k, t in _leaves(first)}
  written = set(k for k, _ in _leaves(after)) - set(
      "." + k for k in forward._INPUTS)
  static = _storages(st.inputs, st.overlay, after, rows)
  for k, t in _leaves(first):
    if t.numel() and (k in written or k.startswith(".contact")):
      assert t.untyped_storage().data_ptr() not in static, k
  # nothing a warm-up wrote is kept until a graph is captured
  assert st.after is None and st.rows is None
  second, _ = st.forward(d2, True, run)
  assert not torch.equal(second.xpos, first.xpos)
  for k, t in _leaves(first):
    assert torch.equal(t, kept[k]), k


def test_a_new_shape_dtype_model_overlay_or_full_data_makes_a_new_key():
  m, d, d2 = _scene("hand23")
  m_legs, d_legs, _ = _scene("legs16_knee")
  key = forward._key(m, d, True)
  assert forward._key(m, d2, True) == key
  fewer = d.replace(**{k: getattr(d, k)[:2] for k in forward._INPUTS})
  double = d.replace(**{k: getattr(d, k).double() for k in forward._INPUTS})
  damped = d.replace(overlay={"dof_damping": torch.zeros_like(d.qvel)})
  keys = {key, forward._key(m, fewer, True), forward._key(m, double, True),
          forward._key(m_legs, d_legs, True), forward._key(m, damped, True),
          forward._key(m, d, False)}
  assert len(keys) == 6


def test_the_cpu_takes_the_eager_stages():
  m, d, _ = _scene("hand23")
  inputs = tuple(getattr(d, k) for k in forward._INPUTS)
  assert not graphs.graphable(inputs)
  staged = dict(forward.staged.entries)
  forward.forward(m, d)
  assert forward.staged.entries == staged


class _HostReads(TorchDispatchMode):
  """Ops a CUDA graph cannot capture: a tensor made from host data, and a
  device value read on the host. A Python number written into a tensor
  shows as a 0-d host tensor (``lift_fresh``); through a plain slice the
  card fills with it, through a tensor index (``index_put``) it is copied
  from the host."""

  def __init__(self):
    super().__init__()
    self.found = []
    self._numbers = []

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    name = str(func)
    out = func(*args, **(kwargs or {}))
    if "lift_fresh" in name:
      if args[0].ndim:
        self.found.append(name)
      else:
        self._numbers.append(out)
    elif "index_put" in name and any(args[2] is t for t in self._numbers):
      self.found.append(name + " of a Python number")
    elif any(s in name for s in ("_local_scalar_dense", "nonzero",
                                 "is_nonzero", "masked_select")):
      self.found.append(name)
    return out


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_graphed_code_reads_nothing_from_the_host(scene):
  m, d, _ = _scene(scene)
  st = forward._Staged(m, d, True)
  st.forward(d, True, _plain)
  with _HostReads() as mode:
    st.stage(d)
    st.smooth()
    st.constraint_rows()
  assert mode.found == []

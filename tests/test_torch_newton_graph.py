"""The Newton solve's staged path (``engine/solver.py`` ``_Staged``), the
code a CUDA graph replays on the card, run on the CPU through the same host
loop with its prologue and block called in place of a replay.

On real Newton inputs (the solves of one control step: hand23 pose with
random actions, contact rows in force; hand23 pose with every muscle
closed, joint-limit and contact rows in force; legs16 walk, equality and
floor-contact rows), the staged loop gives the eager loop's qacc, force,
per-env iterations and host syncs bit for bit; the tensors it returns
share no memory with its static buffers, so a later solve leaves them as
they were; and a change of B, R or a solver scalar makes a new key.
"""
from __future__ import annotations

import functools

import pytest
import torch

from myosuite_mjx_tpu_torch import envs
from myosuite_mjx_tpu_torch.engine import graphs, solver

B = 4
# (task, action: "random" or a constant, control steps); the solves of the
# last step are kept
CASES = {
    "pose": ("hand23PoseFixed-v0", "random", 3),
    "pose-closed": ("hand23PoseFixed-v0", 1.0, 6),
    "legs-walk": ("legs16Walk-v0", 1.0, 3),
}


@functools.lru_cache(maxsize=None)
def _solves(case: str) -> list:
  """(m, d, efc, contact_blocks) of each solve of the case's last step."""
  task, action, steps = CASES[case]
  env = envs.make(task)
  st = env.reset(B, "cpu")
  g = torch.Generator().manual_seed(0)
  rec = []
  inner = solver._solve

  def recorded(m, d, efc, contact_blocks, contact_info, full_data):
    rec.append((m, d, efc, contact_blocks))
    return inner(m, d, efc, contact_blocks, contact_info, full_data)

  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(solver, "_solve", recorded)
    for _ in range(steps):
      rec.clear()
      if action == "random":
        a = torch.rand((B, env.action_dim), generator=g) * 2 - 1
      else:
        a = torch.full((B, env.action_dim), action)
      st = env.autoreset_step(st, a)
  return rec


def _problem(m, d, efc):
  J, aref, D, is_eq, _, _ = efc
  return solver._problem(m, d, J, aref, D, is_eq,
                         int(m.opt.solver_iterations),
                         int(m.opt.ls_iterations))


def _rows_in_force(efc, contact_blocks) -> dict:
  """Rows in force over the batch, by kind."""
  J, _, D, is_eq, _, meta = efc
  force = (D > 0) & ~is_eq
  off, nl = meta["jl_offset"], meta["jl_dadr"].numel()
  nc = contact_blocks["J"].shape[1] if contact_blocks is not None else 0
  return {"equality": int(is_eq.sum()) * B,
          "limit": int(force[:, off:off + nl].sum()),
          "contact": int(force[:, J.shape[1] - nc:].sum()) if nc else 0}


def _plain(part, fn) -> bool:
  """The staged loop's ``run`` without a card: call the part's code."""
  fn()
  return False


def _staged(st, inputs):
  syncs = solver.newton_host_syncs.count
  st.stage(inputs)
  blocks, graphed = st.run(_plain)
  assert not graphed
  return st.outputs(), solver.newton_host_syncs.count - syncs, blocks


@pytest.mark.parametrize("case", sorted(CASES))
def test_staged_loop_matches_eager(case):
  solves = _solves(case)
  rows = [_rows_in_force(efc, cb) for _, _, efc, cb in solves]
  need = {"pose": ("contact",), "pose-closed": ("limit", "contact"),
          "legs-walk": ("equality", "contact")}[case]
  for kind in need:
    assert max(r[kind] for r in rows) > 0, (case, kind, rows)
  st = None
  for m, d, efc, _ in solves:
    inputs, args = _problem(m, d, efc)
    syncs = solver.newton_host_syncs.count
    eager = solver._newton_solve(m, d, *efc[:4], int(m.opt.solver_iterations),
                                 int(m.opt.ls_iterations))
    eager_syncs = solver.newton_host_syncs.count - syncs
    if st is None:
      st = solver._Staged(inputs, args)
    out, syncs, blocks = _staged(st, inputs)
    for a, b, what in zip(out, eager, ("qacc", "force", "iterations")):
      assert torch.equal(a, b), (case, what)
    assert syncs == eager_syncs and blocks == syncs - 1
    assert int(out[2].max()) == solver._BLOCK * blocks


def test_returned_tensors_share_no_memory_with_the_buffers():
  solves = _solves("pose")
  inputs, args = _problem(*solves[0][:3])
  st = solver._Staged(inputs, args)
  first, _, _ = _staged(st, inputs)
  kept = [t.clone() for t in first]
  static = {t.untyped_storage().data_ptr()
            for t in st.inputs + st.carry + (st.live, st.flag)}
  for t in first:
    assert t.untyped_storage().data_ptr() not in static
  for m, d, efc, _ in solves[1:]:
    second, _, _ = _staged(st, _problem(m, d, efc)[0])
  assert not torch.equal(second[0], kept[0])
  for t, k in zip(first, kept):
    assert torch.equal(t, k)


def test_a_new_shape_or_scalar_makes_a_new_key():
  m, d, efc, _ = _solves("pose")[0]
  inputs, args = _problem(m, d, efc)
  key = solver._key(inputs, args)
  J = inputs[3]
  assert solver._key(_problem(m, d, efc)[0], args) == key
  fewer_envs = inputs[:3] + (J[:2],) + inputs[4:]
  fewer_rows = inputs[:3] + (J[:, :-1],) + inputs[4:]
  as_double = inputs[:3] + (J.double(),) + inputs[4:]
  keys = {key, solver._key(fewer_envs, args), solver._key(fewer_rows, args),
          solver._key(as_double, args),
          solver._key(inputs, (args[0] + 1,) + args[1:]),
          solver._key(inputs, args[:2] + (args[2] * 2, args[3]))}
  assert len(keys) == 6


def test_the_cpu_takes_the_eager_loop():
  m, d, efc, _ = _solves("pose")[0]
  inputs, _ = _problem(m, d, efc)
  assert not graphs.graphable(inputs)
  staged = dict(solver.staged.entries)
  solver._newton_solve(m, d, *efc[:4], int(m.opt.solver_iterations),
                       int(m.opt.ls_iterations))
  assert solver.staged.entries == staged

"""The port's spans and its counters (``utils/spans.py``), and the
benchmark's readers of them, on the CPU: hand23 pose and legs16 walk,
B = 4.

Without a profiler a span is one shared no-op and the counters keep
nothing. Under ``torch.profiler`` the outermost host ranges of one
``autoreset_step`` are the documented top-level spans in order, the
narrowphase group spans sit inside ``engine.contacts``, the outputs are
bit-identical to an unprofiled step, the Newton counter holds what the
Newton solves returned, and the block counter counts every block, none
from a CUDA graph (the CPU runs the eager loop); the forward counter and
the fused-solve counter count only on the card, so nothing here, and keep
nothing without a profiler. On the walk, whose reset
solves its constraints too, the row counter counts each solve's rows
holding force (the knees' equality rows among them) against the rows it
carries, and the reset counter the envs that took their fresh reset
against the batch. On the hulls scene (B = 4, twenty steps) the mesh
counter counts the kept mesh slots in force that the steps' contact forces
show, against B x the narrowphase's 7 mesh slots a solve; without a
profiler the solve calls it not at all, and on hand23, which has no mesh,
it keeps nothing.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from myosuite_mjx_tpu_torch import envs
from myosuite_mjx_tpu_torch.engine import solver
from myosuite_mjx_tpu_torch.utils import spans

B = 4
TASK = "hand23PoseFixed-v0"
METRICS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmark", "metrics")
IDLE_READERS = {
    "idle_share.position": {spans.FWD_POSITION},
    "idle_share.smooth": {spans.FWD_VELOCITY, spans.FWD_ACTUATION,
                          spans.FWD_PASSIVE, spans.FWD_ACCELERATION,
                          spans.EULER},
    "idle_share.contacts": {spans.CONTACTS, spans.MAKE_EFC},
    "idle_share.newton": {spans.NEWTON},
    "idle_share.task": {spans.ENV_CONTROL, spans.ENV_TASK, spans.ENV_SELECT},
    "idle_share.reset": {spans.ENV_RESET},
}


def _reader(name: str):
  spec = importlib.util.spec_from_file_location(
      "metric_" + name.replace(".", "_"), os.path.join(METRICS, name + ".py"))
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def _leaves(x, path=""):
  """(path, tensor) of every tensor in a state, dataclasses and dicts
  walked."""
  if isinstance(x, torch.Tensor):
    yield path, x
  elif isinstance(x, dict):
    for k in sorted(x):
      yield from _leaves(x[k], f"{path}.{k}")
  elif dataclasses.is_dataclass(x):
    for f in dataclasses.fields(x):
      yield from _leaves(getattr(x, f.name), f"{path}.{f.name}")


def _outermost(events) -> list:
  """(name, start, end) of the outermost host ranges, in start order."""
  host = sorted((e.start_ns(), -e.start_ns() - e.duration_ns(), e.name())
                for e in events)
  top = []
  for s, neg_e, n in host:
    e = -neg_e
    if top and s < top[-1][2]:
      continue
    top.append((n, s, e))
  return top


@pytest.fixture(scope="module")
def env_and_state():
  env = envs.make(TASK)
  st = env.reset(B, "cpu")
  action = torch.rand((B, env.action_dim),
                      generator=torch.Generator().manual_seed(0)) * 2 - 1
  st = env.autoreset_step(st, action)
  return env, st, action


@pytest.fixture(scope="module")
def traced(env_and_state):
  """One unprofiled and one profiled ``autoreset_step`` from the same
  state; the profiled one records what each Newton solve returned and the
  host syncs it made."""
  env, st, action = env_and_state
  plain = env.autoreset_step(st, action)
  solves = []
  inner = solver._newton_solve

  def recorded(*args, **kw):
    syncs = solver.newton_host_syncs.count
    out = inner(*args, **kw)
    solves.append((out[2], solver.newton_host_syncs.count - syncs))
    return out

  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(solver, "_newton_solve", recorded)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
      out = env.autoreset_step(st, action)
  events = list(prof.profiler.kineto_results.events())
  return {"plain": plain, "out": out, "events": events, "solves": solves,
          "work": spans.newton_work(), "blocks": spans.newton_graph_blocks(),
          "forwards": spans.forward_graph_passes(),
          "fused": spans.newton_fused_solves(),
          "frame_skip": env.frame_skip}


def test_no_profiler_no_span_and_nothing_kept(env_and_state, monkeypatch):
  env, st, action = env_and_state

  def refuse(name):
    raise AssertionError(f"a record_function {name} without a profiler")

  assert not spans.recording()
  for name in spans.TOP_LEVEL + (spans.GROUP + "CAPSULE-CAPSULE",):
    assert spans.span(name) is spans.NOOP
  kept = [id(t) for t in spans._kept]
  monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
  env.autoreset_step(st, action)
  assert [id(t) for t in spans._kept] == kept
  assert spans._stale


def test_outermost_ranges_are_the_top_level_spans(traced):
  names = [n for n, _, _ in _outermost(traced["events"])]
  assert names == ([spans.ENV_CONTROL]
                   + list(spans.SUBSTEP) * traced["frame_skip"]
                   + [spans.ENV_TASK, spans.ENV_RESET, spans.ENV_SELECT])


def test_group_spans_sit_inside_contacts(traced):
  top = _outermost(traced["events"])
  groups = [(e.name(), e.start_ns()) for e in traced["events"]
            if e.name().startswith(spans.GROUP)]
  assert {n for n, _ in groups} == {"contacts.PLANE-CAPSULE",
                                    "contacts.CAPSULE-CAPSULE"}
  assert len(groups) == 2 * traced["frame_skip"]
  for _, start in groups:
    outer = [n for n, s, e in top if s <= start < e]
    assert outer == [spans.CONTACTS]


def test_outputs_identical_with_and_without_profiler(traced):
  plain = dict(_leaves(traced["plain"]))
  out = dict(_leaves(traced["out"]))
  assert plain.keys() == out.keys() and plain
  for k in plain:
    assert torch.equal(plain[k], out[k]), k


def test_newton_work_is_what_the_solves_returned(traced):
  solves = traced["solves"]
  assert len(solves) == traced["frame_skip"]
  useful = sum(int(it.sum()) for it, _ in solves)
  # the batch ran 2 iterations a block, one sync a block plus the exit
  run = sum(B * 2 * (syncs - 1) for _, syncs in solves)
  assert run == sum(B * int(it.max()) for it, _ in solves)
  assert traced["work"] == (useful, run)
  assert 0 < useful <= run


def test_newton_reader_reads_the_counter(traced):
  useful, run = traced["work"]
  read = _reader("newton_useful_share").read
  assert read({"trace": {"idle_by_host_op": {}}}) == pytest.approx(
      100.0 * useful / run)
  assert read({}) is None


def test_newton_blocks_counted_and_none_from_a_graph_on_the_cpu(traced):
  # one sync a block plus the exit; the CPU runs the eager loop
  blocks = sum(syncs - 1 for _, syncs in traced["solves"])
  assert traced["blocks"] == (0, blocks) and blocks > 0


def test_newton_graph_reader_reads_the_counter(monkeypatch):
  read = _reader("newton_graph_share").read
  ctx = {"trace": {"idle_by_host_op": {}}}
  monkeypatch.setattr(spans, "newton_graph_blocks", lambda: (7, 8))
  assert read(ctx) == pytest.approx(87.5)
  assert read({}) is None
  monkeypatch.setattr(spans, "newton_graph_blocks", lambda: (0, 0))
  assert read(ctx) is None
  # a program without the counter (the parent of the graph path)
  monkeypatch.delattr(spans, "newton_graph_blocks")
  assert read(ctx) is None


def test_newton_fused_solves_counted_on_the_card_only(traced):
  # the CPU's solves take the eager loop and are not counted
  assert traced["fused"] == (0, 0)
  with profile(activities=[ProfilerActivity.CPU]):
    for fused in (True, False, True, True):
      spans.newton_fused(fused)
    assert spans.newton_fused_solves() == (3, 4)
  assert spans.newton_fused_solves() == (3, 4)
  # nothing kept without a profiler
  spans.newton_fused(True)
  assert spans.newton_fused_solves() == (3, 4) and spans._stale


def test_newton_fused_reader_reads_the_counter(monkeypatch):
  read = _reader("newton_fused_share").read
  ctx = {"trace": {"idle_by_host_op": {}}}
  monkeypatch.setattr(spans, "newton_fused_solves", lambda: (30, 40))
  assert read(ctx) == pytest.approx(75.0)
  assert read({}) is None
  monkeypatch.setattr(spans, "newton_fused_solves", lambda: (0, 0))
  assert read(ctx) is None
  # a program without the counter (the parent of the fused kernel)
  monkeypatch.delattr(spans, "newton_fused_solves")
  assert read(ctx) is None


def test_forward_passes_counted_on_the_card_only(traced):
  assert traced["forwards"] == (0, 0)
  with profile(activities=[ProfilerActivity.CPU]):
    for graphed in (True, False, True):
      spans.forward_pass(graphed)
    assert spans.forward_graph_passes() == (2, 3)
  assert spans.forward_graph_passes() == (2, 3)
  # nothing kept without a profiler
  spans.forward_pass(True)
  assert spans.forward_graph_passes() == (2, 3) and spans._stale


def test_forward_graph_reader_reads_the_counter(monkeypatch):
  read = _reader("forward_graph_share").read
  ctx = {"trace": {"idle_by_host_op": {}}}
  monkeypatch.setattr(spans, "forward_graph_passes", lambda: (21, 24))
  assert read(ctx) == pytest.approx(87.5)
  assert read({}) is None
  monkeypatch.setattr(spans, "forward_graph_passes", lambda: (0, 0))
  assert read(ctx) is None
  # a program without the counter (the parent of the forward graphs)
  monkeypatch.delattr(spans, "forward_graph_passes")
  assert read(ctx) is None


def test_readers_list_the_documented_spans():
  lists = {n: set(_reader(n).SPANS) for n in IDLE_READERS}
  assert lists == IDLE_READERS
  union = set().union(*lists.values())
  assert sum(map(len, lists.values())) == len(union)
  assert union == set(spans.TOP_LEVEL)
  assert _reader("idle_share.outside_spans").SPANS == spans.TOP_LEVEL


IDLE = {spans.ENV_CONTROL: 0.011, spans.FWD_POSITION: 0.12,
        spans.FWD_VELOCITY: 0.03, spans.FWD_ACTUATION: 0.02,
        spans.FWD_PASSIVE: 0.01, spans.FWD_ACCELERATION: 0.025,
        spans.CONTACTS: 0.07, spans.MAKE_EFC: 0.015, spans.NEWTON: 0.4,
        spans.EULER: 0.018, spans.ENV_TASK: 0.009, spans.ENV_RESET: 0.035,
        spans.ENV_SELECT: 0.004, "host: no op": 0.02, "aten::clone": 0.013}
TRACE = {"busy_s": 1.6 - sum(IDLE.values()), "window_s": 1.6,
         "launches": 100, "kernel_s": {}, "idle_by_host_op": IDLE}


@pytest.mark.parametrize("name", sorted(IDLE_READERS) + [
    "idle_share.outside_spans"])
def test_idle_reader_share(name):
  mine = IDLE_READERS.get(name)
  idle = sum(v for k, v in IDLE.items()
             if (k in mine if mine else k not in spans.TOP_LEVEL))
  got = _reader(name).read({"trace": TRACE, "substeps": 10})
  assert got == pytest.approx(100.0 * idle / TRACE["window_s"])
  assert _reader(name).read({"trace": {
      **TRACE, "idle_by_host_op": {"aten::mul": 0.5, "host: no op": 0.2}}}) \
      is None
  assert _reader(name).read({}) is None


def test_idle_readers_sum_to_the_idle_share():
  ctx = {"trace": TRACE, "substeps": 10}
  total = sum(_reader(n).read(ctx) for n in list(IDLE_READERS)
              + ["idle_share.outside_spans"])
  assert total == pytest.approx(_reader("device_idle_share.env").read(ctx))


WALK = "legs16Walk-v0"


@pytest.fixture(scope="module")
def walk_traced():
  """One profiled ``autoreset_step`` of legs16 walk from the random reset,
  two clocks at their last step; what each Newton solve returned."""
  env = envs.make(WALK)
  g = torch.Generator().manual_seed(3)
  st = env.reset(B, "cpu", g)
  st = st.replace(steps=torch.tensor([0, env.horizon - 1, 0,
                                      env.horizon - 1], dtype=torch.int32))
  action = torch.rand((B, env.action_dim), generator=g) * 2 - 1
  forces = []
  inner = solver._newton_solve

  def recorded(*args, **kw):
    out = inner(*args, **kw)
    forces.append(out[1])
    return out

  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(solver, "_newton_solve", recorded)
    with profile(activities=[ProfilerActivity.CPU]):
      out = env.autoreset_step(st, action)
  return {"env": env, "state": st, "action": action, "out": out,
          "forces": forces, "rows": spans.efc_row_use(),
          "resets": spans.reset_use()}


def test_row_counter_counts_each_solves_rows_in_force(walk_traced):
  forces, env = walk_traced["forces"], walk_traced["env"]
  # frame_skip substeps and the reset, each one solve
  assert len(forces) == env.frame_skip + 1
  R = forces[0].shape[1]
  n_eq = env.model.neq
  assert n_eq == 2
  for f in forces:
    # the knees' equality rows hold force in every env
    assert (f[:, :n_eq] != 0).all()
  used = sum(int((f != 0).sum()) for f in forces)
  assert walk_traced["rows"] == (used, len(forces) * B * R)
  assert len(forces) * B * n_eq < used < len(forces) * B * R


def test_reset_counter_counts_kept_resets(walk_traced):
  info = walk_traced["out"].info
  kept = info["terminated"] | info["truncated"]
  assert info["truncated"][1::2].all()
  assert walk_traced["resets"] == (int(kept.sum()), B)


def test_row_and_reset_counters_keep_nothing_without_a_profiler(
    walk_traced):
  env, st, action = (walk_traced[k] for k in ("env", "state", "action"))
  assert not spans.recording()
  before = ([id(t) for t, _ in spans._rows], [id(t) for t in spans._resets])
  env.autoreset_step(st, action)
  assert ([id(t) for t, _ in spans._rows],
          [id(t) for t in spans._resets]) == before
  assert spans._stale


@pytest.mark.parametrize("name,counter,counts,share", [
    ("efc_row_use", "efc_row_use", (57, 456), 12.5),
    ("reset_useful_share", "reset_use", (3, 8192), 100.0 * 3 / 8192)])
def test_row_and_reset_readers_read_their_counter(name, counter, counts,
                                                  share, monkeypatch):
  read = _reader(name).read
  ctx = {"trace": {"idle_by_host_op": {}}}
  monkeypatch.setattr(spans, counter, lambda: counts)
  assert read(ctx) == pytest.approx(share)
  assert read({}) is None
  monkeypatch.setattr(spans, counter, lambda: (0, 0))
  assert read(ctx) is None
  # a program without the counter (the parent of these counters)
  monkeypatch.delattr(spans, counter)
  assert read(ctx) is None


HULLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "myosuite_mjx_tpu_torch", "assets", "hulls.npz")


@pytest.fixture(scope="module")
def hulls_traced():
  """Twenty profiled ``Physics.step``s of the hulls scene (a mesh slab on
  a plane, a sphere, capsule and ellipsoid falling onto it) at B = 4, from
  random velocities; each step's contact set and contact forces."""
  from myosuite_mjx_tpu_torch.engine import api, collision
  phys = api.load(HULLS, torch.float64, "cpu")
  d = phys.make_data(B)
  g = torch.Generator().manual_seed(0)
  d = d.replace(qvel=0.3 * torch.randn(d.qvel.shape, generator=g,
                                       dtype=torch.float64))
  start, steps = d, []
  with profile(activities=[ProfilerActivity.CPU]):
    for _ in range(20):
      d = phys.step(d)
      steps.append(d)
  return {"phys": phys, "start": start, "steps": steps,
          "mesh": collision.mesh_slots(phys.device_model),
          "use": spans.mesh_contact_use()}


def test_mesh_counter_counts_the_mesh_slots_in_force(hulls_traced):
  mesh, slots = hulls_traced["mesh"]
  steps = hulls_traced["steps"]
  # the slab's four plane-mesh slots and one each of sphere, capsule and
  # ellipsoid against it, of the scene's eleven
  assert slots == 7 and int(mesh.sum()) == 1
  direct = sum(int(((d.contact_force != 0) & mesh[d.contact.geom2]).sum())
               for d in steps)
  assert direct > 0
  assert hulls_traced["use"] == (direct, len(steps) * B * slots)


def test_mesh_counter_keeps_nothing_and_runs_nothing_without_a_profiler(
    hulls_traced, monkeypatch):
  calls = []
  monkeypatch.setattr(spans, "mesh_contacts_used",
                      lambda *a: calls.append(a))
  assert not spans.recording()
  kept = list(spans._mesh)
  hulls_traced["phys"].step(hulls_traced["start"])
  # the solve tests the flag and calls nothing: no op, so no launch
  assert calls == [] and spans._mesh == kept


def test_mesh_counter_keeps_nothing_without_a_mesh(env_and_state):
  env, st, action = env_and_state
  with profile(activities=[ProfilerActivity.CPU]):
    env.autoreset_step(st, action)
    assert spans.mesh_contact_use() == (0, 0)
  assert spans.efc_row_use()[1] > 0


def test_mesh_reader_reads_its_counter(monkeypatch):
  read = _reader("mesh_contact_use").read
  ctx = {"trace": {"idle_by_host_op": {}}}
  monkeypatch.setattr(spans, "mesh_contact_use", lambda: (41, 4096 * 10))
  assert read(ctx) == pytest.approx(100.0 * 41 / 40960)
  assert read({}) is None
  monkeypatch.setattr(spans, "mesh_contact_use", lambda: (0, 0))
  assert read(ctx) is None
  # a program without the counter (the parent of this counter)
  monkeypatch.delattr(spans, "mesh_contact_use")
  assert read(ctx) is None

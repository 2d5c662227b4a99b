"""Named host ranges on the control step, and the Newton useful-work counter.

Both exist only while a torch profiler records; otherwise ``span`` returns
one shared no-op context and ``newton_solved`` keeps nothing, at the cost
of one flag test each.

``span(name)`` is a ``torch.profiler.record_function`` range, so it lands in
the same timeline as the device's kernels, and a reader of the trace can
name each of the device's idle gaps by the span the host was in. The
top-level spans partition a control step; none wraps a whole control step
or substep, so the outermost range over any moment is a stage:

- ``env.control`` (``MyoEnv.control`` in ``MyoEnv.step``),
- per substep ``engine.fwd_position`` (kinematics, tendons with their
  wraps, transmission), ``engine.fwd_velocity``, ``engine.fwd_actuation``,
  ``engine.fwd_passive``, ``engine.fwd_acceleration``, ``engine.contacts``,
  ``engine.make_efc``, ``engine.newton`` (the solve and the force scatter)
  and ``engine.euler``; on the card's graph path (``forward.forward``) the
  replay of the smooth stages sits in ``engine.fwd_position`` and that of
  contacts and rows in ``engine.contacts``; the stages' own spans open
  only nested inside these, while a graph's code warms up or is captured
  (``engine/graphs.py``),
- ``env.task`` (obs, reward and done of the stepped state),
- ``env.reset`` (``autoreset_step``'s fresh reset: its forward stages nest
  inside it),
- ``env.select`` (the per-env merge of the reset into the stepped state).

Nested inside ``engine.contacts``, one ``contacts.<TYPE1>-<TYPE2>`` span per
narrowphase type group (``contacts.CAPSULE-MESH``). The names are a contract
with the trace's readers (``benchmark/metrics/idle_share.*.py``,
``tools/profile_step.py``).

The Newton counter keeps each solve's per-env iteration counts [B] (no sync,
no launch) and reduces them only when ``newton_work`` reads them. Beside
it, ``newton_graph_blocks`` counts the Newton blocks run from a CUDA graph
and all Newton blocks (``engine/solver.py``; the fused kernel's solves run
no block on the host), ``newton_fused_solves`` the solves on the card and
those the fused Newton kernel served, and ``forward_graph_passes``
the forward passes on the card served by CUDA graph replays and all forward
passes on the card (``engine/forward.py``). Two more counters follow the
same rule: ``efc_rows_used`` keeps each solve's per-env count of rows
holding a nonzero force [B] (one launch a solve), read by ``efc_row_use``;
``resets_kept`` keeps each ``autoreset_step``'s mask of the envs that took
their fresh reset [B] (no launch), read by ``reset_use``. And
``mesh_contacts_used`` keeps each solve's mask [B, ncon] of the kept
contacts that are a mesh pair's and hold a nonzero normal force (one
reduction launch a solve; nothing where the scene has no mesh), read by
``mesh_contact_use``.
"""
from __future__ import annotations

import contextlib

import torch

ENV_CONTROL = "env.control"
FWD_POSITION = "engine.fwd_position"
FWD_VELOCITY = "engine.fwd_velocity"
FWD_ACTUATION = "engine.fwd_actuation"
FWD_PASSIVE = "engine.fwd_passive"
FWD_ACCELERATION = "engine.fwd_acceleration"
CONTACTS = "engine.contacts"
MAKE_EFC = "engine.make_efc"
NEWTON = "engine.newton"
EULER = "engine.euler"
ENV_TASK = "env.task"
ENV_RESET = "env.reset"
ENV_SELECT = "env.select"

SUBSTEP = (FWD_POSITION, FWD_VELOCITY, FWD_ACTUATION, FWD_PASSIVE,
           FWD_ACCELERATION, CONTACTS, MAKE_EFC, NEWTON, EULER)
TOP_LEVEL = (ENV_CONTROL,) + SUBSTEP + (ENV_TASK, ENV_RESET, ENV_SELECT)
GROUP = "contacts."     # + "<TYPE1>-<TYPE2>", inside CONTACTS

NOOP = contextlib.nullcontext()
recording = torch._C._autograd._profiler_enabled


def span(name: str):
  """A named host range while a profiler records, else ``NOOP``."""
  if recording():
    return torch.autograd.profiler.record_function(name)
  return NOOP


# per-env Newton iterations [B] of each solve since the latest recording
# began (a profiler is process-wide, and so is what it records); each
# holds B int32, far less than the profiler's own events of that solve
_kept: list = []
# Newton blocks since the latest recording began: [from a graph, all]
_blocks = [0, 0]
# Newton solves on the card since the latest recording began: [served by
# the fused kernel, all]
_fused = [0, 0]
# forward passes on the card since the latest recording began: [served by
# graph replays, all]
_forwards = [0, 0]
# (rows in force per env [B], rows a solve carries) of each solve, and
# the mask of kept resets [B] of each autoreset step, since the latest
# recording began
_rows: list = []
_resets: list = []
# (mesh contacts in force [B, ncon] bool, the narrowphase's mesh slots) of
# each solve since the latest recording began
_mesh: list = []
_stale = True     # no profiler recorded at the last solve


def _keeping() -> bool:
  """Whether a profiler records; the first call of a recording drops what
  an earlier recording kept."""
  global _stale
  if not recording():
    _stale = True
    return False
  if _stale:
    _kept.clear()
    _blocks[:] = [0, 0]
    _fused[:] = [0, 0]
    _forwards[:] = [0, 0]
    _rows.clear()
    _resets.clear()
    _mesh.clear()
    _stale = False
  return True


def newton_solved(iterations: torch.Tensor) -> None:
  """Keep one solve's per-env iteration counts while a profiler records."""
  if _keeping():
    _kept.append(iterations)


def newton_blocks(run: int, graphed: bool) -> None:
  """Count one solve's ``run`` blocks, as run from a CUDA graph or not,
  while a profiler records."""
  if _keeping():
    _blocks[0] += run if graphed else 0
    _blocks[1] += run


def newton_graph_blocks() -> tuple[int, int]:
  """(Newton blocks run from a CUDA graph, all Newton blocks) over the
  solves of the latest recording."""
  return _blocks[0], _blocks[1]


def newton_fused(fused: bool) -> None:
  """Count one Newton solve on the card, served by the fused kernel or
  not, while a profiler records."""
  if _keeping():
    _fused[0] += bool(fused)
    _fused[1] += 1


def newton_fused_solves() -> tuple[int, int]:
  """(Newton solves on the card served by the fused kernel, all Newton
  solves on the card) over the latest recording."""
  return _fused[0], _fused[1]


def forward_pass(graphed: bool) -> None:
  """Count one forward pass on the card, served by graph replays or not,
  while a profiler records."""
  if _keeping():
    _forwards[0] += bool(graphed)
    _forwards[1] += 1


def forward_graph_passes() -> tuple[int, int]:
  """(forward passes on the card served by CUDA graph replays, all forward
  passes on the card) over the latest recording."""
  return _forwards[0], _forwards[1]


def newton_work() -> tuple[int, int]:
  """(sum of the per-env iterations, B x the iterations the batch ran) over
  the solves of the latest recording.

  The batch runs its blocks until no env is live, and an env stops for
  good, so the batch ran as many iterations as its busiest env: the second
  number is B x the largest count, summed over solves. The first over the
  second is the share of the batch's Newton work that some env needed.
  """
  useful = sum(int(it.sum()) for it in _kept)
  run = sum(it.numel() * int(it.max()) for it in _kept)
  return useful, run


def efc_rows_used(force: torch.Tensor) -> None:
  """Keep one solve's count of rows holding a nonzero force per env, from
  its forces [B, R], while a profiler records (one reduction launch)."""
  if _keeping():
    _rows.append((torch.linalg.vector_norm(force, ord=0, dim=-1),
                  force.shape[-1]))


def efc_row_use() -> tuple[int, int]:
  """(rows holding a nonzero force, summed over envs and solves, B x the
  rows each solve carries, summed over solves) over the solves of the
  latest recording."""
  used = sum(int(n.sum(dtype=torch.float64)) for n, _ in _rows)
  carried = sum(n.numel() * rows for n, rows in _rows)
  return used, carried


def resets_kept(kept: torch.Tensor) -> None:
  """Keep one autoreset step's mask [B] of the envs whose fresh reset
  the step took, while a profiler records."""
  if _keeping():
    _resets.append(kept)


def reset_use() -> tuple[int, int]:
  """(fresh resets kept, fresh resets computed) over the autoreset steps of
  the latest recording: every step computes one for each env."""
  return (sum(int(k.sum()) for k in _resets),
          sum(k.numel() for k in _resets))


def mesh_contacts_used(lam: torch.Tensor, geom2: torch.Tensor,
                       mesh: torch.Tensor, slots: int) -> None:
  """Keep one solve's mask of the kept contacts [B, ncon] that are a mesh
  pair's and hold a nonzero normal force, from the contact rows' forces
  ``lam`` [B, ncon, rows a contact], the contacts' ``geom2`` and which
  geoms are meshes ``mesh`` [ngeom], while a profiler records and the
  narrowphase has mesh ``slots`` (one reduction launch)."""
  if slots and _keeping():
    _mesh.append(((lam.sum(-1) != 0) & mesh[geom2], slots))


def mesh_contact_use() -> tuple[int, int]:
  """(mesh slots holding a nonzero normal force, summed over envs and
  solves; B x the mesh slots the narrowphase computes, summed over
  solves) over the solves of the latest recording."""
  return (sum(int(k.sum()) for k, _ in _mesh),
          sum(k.shape[0] * slots for k, slots in _mesh))

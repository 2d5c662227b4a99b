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
  and ``engine.euler``,
- ``env.task`` (obs, reward and done of the stepped state),
- ``env.reset`` (``autoreset_step``'s fresh reset: its forward stages nest
  inside it),
- ``env.select`` (the per-env merge of the reset into the stepped state).

Nested inside ``engine.contacts``, one ``contacts.<TYPE1>-<TYPE2>`` span per
narrowphase type group (``contacts.CAPSULE-MESH``). The names are a contract
with the trace's readers (``benchmark/metrics/idle_share.*.py``,
``tools/profile_step.py``).

The Newton counter keeps each solve's per-env iteration counts [B] (no sync,
no launch) and reduces them only when ``newton_work`` reads them.
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
_stale = True     # no profiler recorded at the last solve


def newton_solved(iterations: torch.Tensor) -> None:
  """Keep one solve's per-env iteration counts while a profiler records.

  The first solve of a recording drops what an earlier recording kept.
  """
  global _stale
  if not recording():
    _stale = True
    return
  if _stale:
    _kept.clear()
    _stale = False
  _kept.append(iterations)


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

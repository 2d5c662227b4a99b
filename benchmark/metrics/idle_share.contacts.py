"""The device's idle time while the host was in the narrowphase and the
constraint rows, in % of the traced window: the idle gaps that the trace
names by the program's spans ``engine.contacts``, ``engine.make_efc``
(``myosuite_mjx_tpu_torch/utils/spans.py``) over the window's wall time.
Moves ``physics_steps_per_s``. None where the trace holds no span of the
program."""

SPANS = ("engine.contacts", "engine.make_efc")


def read(ctx: dict):
  tr = ctx.get("trace")
  idle = tr["idle_by_host_op"] if tr else {}
  if not any(n.startswith(("engine.", "env.")) for n in idle):
    return None
  return 100.0 * sum(idle.get(n, 0.0) for n in SPANS) / tr["window_s"]

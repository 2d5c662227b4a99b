"""The device's idle time while the host was in the Newton solve and its
force scatter, in % of the traced window: the idle gaps that the trace names
by the program's span ``engine.newton``
(``myosuite_mjx_tpu_torch/utils/spans.py``) over the window's wall time.
Moves ``physics_steps_per_s``. None where the trace holds no span of the
program."""

SPANS = ("engine.newton",)


def read(ctx: dict):
  tr = ctx.get("trace")
  idle = tr["idle_by_host_op"] if tr else {}
  if not any(n.startswith(("engine.", "env.")) for n in idle):
    return None
  return 100.0 * sum(idle.get(n, 0.0) for n in SPANS) / tr["window_s"]

"""The device's idle time while the host was outside the program's spans,
in % of the traced window: the idle gaps that the trace names by any other
host op or by none (``host: no op``), such as the harness's copies of each
state and Python between two spans, over the window's wall time. The seven
``idle_share.*`` metrics sum to the window's idle time; this one is what
the spans fail to cover. Moves ``physics_steps_per_s``. None where the trace
holds no span of the program."""

# every top-level span of myosuite_mjx_tpu_torch/utils/spans.py
SPANS = ("env.control", "engine.fwd_position", "engine.fwd_velocity",
         "engine.fwd_actuation", "engine.fwd_passive",
         "engine.fwd_acceleration", "engine.contacts", "engine.make_efc",
         "engine.newton", "engine.euler", "env.task", "env.reset",
         "env.select")


def read(ctx: dict):
  tr = ctx.get("trace")
  idle = tr["idle_by_host_op"] if tr else {}
  if not any(n.startswith(("engine.", "env.")) for n in idle):
    return None
  return 100.0 * sum(v for n, v in idle.items()
                     if n not in SPANS) / tr["window_s"]

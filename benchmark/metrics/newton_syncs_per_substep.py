"""Host syncs of the Newton loop (the program's counter
``engine.solver.newton_host_syncs``, its increase over the traced window)
per physics substep of the batch. Moves ``physics_steps_per_s``."""


def read(ctx: dict):
  if not ctx.get("substeps") or ctx.get("newton_syncs") is None:
    return None
  return ctx["newton_syncs"] / ctx["substeps"]

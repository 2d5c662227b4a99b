"""Device kernels launched in the traced window (the trace's count, memcpy
and memset left out) per physics substep of the batch. Moves
``physics_steps_per_s``: the step is host-bound, and each launch costs the
host its dispatch."""


def read(ctx: dict):
  tr = ctx.get("trace")
  if not tr or not tr["launches"] or not ctx.get("substeps"):
    return None
  return tr["launches"] / ctx["substeps"]

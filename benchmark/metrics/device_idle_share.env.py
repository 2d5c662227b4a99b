"""The device's idle share over the traced window of env steps: 1 - (the
union of its kernel, memcpy and memset intervals) / the window's wall time,
in %. Moves ``physics_steps_per_s``."""


def read(ctx: dict):
  tr = ctx.get("trace")
  if not tr or tr["busy_s"] <= 0 or "substeps" not in ctx:
    return None
  return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])

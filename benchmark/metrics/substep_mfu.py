"""The whole substep's share of the card's float32 peak, in %: a lower
bound on the substeps' FLOPs (``counts.substep_flops`` at the scene's nv
and nu, with the constraint rows in force read from the window's states:
limits and contacts whose force is not zero) x batch x substeps, over the
traced window's wall time, over 67 TFLOP/s. Moves
``physics_steps_per_s``."""
from benchmark.harness import counts


def read(ctx: dict):
  tr, peak = ctx.get("trace"), counts.peaks(ctx.get("device_name", ""))
  if not tr or peak is None or not ctx.get("substeps"):
    return None
  flops = (counts.substep_flops(ctx["nv"], ctx["nu"], ctx["rows_in_force"])
           * ctx["batch"] * ctx["substeps"])
  return 100.0 * flops / tr["window_s"] / peak["fp32_flops"]

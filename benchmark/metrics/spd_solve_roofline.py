"""The SPD-solve kernel's share of its roofline, in %: the least time the
window's solves need on the card (per launch the larger of its bytes, A, b
and x once each, over the HBM bandwidth, and its FLOPs over the float32
peak, at [batch, nv] float32; launches from the program's counter
``ops.cuda_linalg.spd_solve_cuda.launches``) over the device time of the
kernels of ``csrc/spd_solve.cu`` in the trace. Moves
``physics_steps_per_s``."""
from benchmark.harness import counts

KERNEL = "spd_solve_kernel"


def read(ctx: dict):
  tr, peak = ctx.get("trace"), counts.peaks(ctx.get("device_name", ""))
  if not tr or peak is None or not ctx.get("spd_launches"):
    return None
  seconds = sum(s for name, s in tr["kernel_s"].items() if KERNEL in name)
  if seconds <= 0:
    return None
  least = ctx["spd_launches"] * counts.spd_least_seconds(
      ctx["nv"], ctx["batch"], peak, ctx["itemsize"])
  return 100.0 * least / seconds

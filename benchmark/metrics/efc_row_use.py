"""The share of the Newton solve's constraint rows that hold a force, in %:
the program's counter ``myosuite_mjx_tpu_torch.utils.spans.efc_row_use()``
over the traced window's solves (the resets' included), 100 x (the rows
holding a nonzero force, summed over envs and solves) / (B x the rows each
solve carries, summed over solves). The rest is row work on slots that are
empty or inactive. Moves ``physics_steps_per_s``. None outside a traced
window, where the program has no such counter, or where it kept no
solve."""


def read(ctx: dict):
  if not ctx.get("trace"):
    return None
  try:
    from myosuite_mjx_tpu_torch.utils import spans
  except ImportError:
    return None
  counts = getattr(spans, "efc_row_use", None)
  if counts is None:
    return None
  used, carried = counts()
  if not carried:
    return None
  return 100.0 * used / carried

"""The share of the fresh resets that the autoreset step kept, in %: the
program's counter ``myosuite_mjx_tpu_torch.utils.spans.reset_use()`` over
the traced window's control steps, 100 x (envs that terminated or reached
the horizon, whose fresh reset the step took) / (envs the reset computed,
the whole batch each step). The rest is reset work thrown away. Moves
``physics_steps_per_s``. None outside a traced window, where the program
has no such counter, or where it kept no step."""


def read(ctx: dict):
  if not ctx.get("trace"):
    return None
  try:
    from myosuite_mjx_tpu_torch.utils import spans
  except ImportError:
    return None
  counts = getattr(spans, "reset_use", None)
  if counts is None:
    return None
  kept, computed = counts()
  if not computed:
    return None
  return 100.0 * kept / computed

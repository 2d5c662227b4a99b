"""The share of the batch's Newton work that some env still needed, in %:
the program's counter ``myosuite_mjx_tpu_torch.utils.spans.newton_work()``
over the traced window's solves, 100 x (the sum of the per-env iterations)
/ (B x the iterations the batch ran). The rest is lock-step work on envs
already done. Moves ``physics_steps_per_s``. None outside a traced window,
where the program has no such counter, or where it kept no solve."""


def read(ctx: dict):
  if not ctx.get("trace"):
    return None
  try:
    from myosuite_mjx_tpu_torch.utils import spans
  except ImportError:
    return None
  useful, run = spans.newton_work()
  if not run:
    return None
  return 100.0 * useful / run

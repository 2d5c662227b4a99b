"""The share of the Newton solves on the card served by the fused Newton
kernel, in %: the program's counter
``myosuite_mjx_tpu_torch.utils.spans.newton_fused_solves()`` over the
traced window, 100 x (solves run as one launch of the kernel, each env to
its own exit) / (all Newton solves on the card). Moves
``physics_steps_per_s``: a fused solve costs the host one launch and no
sync where a solve of graph-replayed blocks costs a replay and a sync a
block. None outside a traced window, where the program has no such
counter, or where it ran no solve on the card."""


def read(ctx: dict):
  if not ctx.get("trace"):
    return None
  try:
    from myosuite_mjx_tpu_torch.utils import spans
  except ImportError:
    return None
  counts = getattr(spans, "newton_fused_solves", None)
  if counts is None:
    return None
  fused, run = counts()
  if not run:
    return None
  return 100.0 * fused / run

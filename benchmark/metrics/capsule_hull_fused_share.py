"""The share of the capsule-mesh narrowphase group calls on the card served
by the capsule-hull kernel, in %: the program's counter
``myosuite_mjx_tpu_torch.utils.spans.capsule_hull_fused_groups()`` over the
traced window, 100 x (group calls run as one launch of the kernel) / (all
capsule-mesh group calls on the card), graph replays included. Moves
``physics_steps_per_s``: a fused group is one launch where the plain path
is some 3,700 small kernels a forward. None outside a traced window, where
the program has no such counter, or where it ran no capsule-mesh group on
the card (a scene without one)."""


def read(ctx: dict):
  if not ctx.get("trace"):
    return None
  try:
    from myosuite_mjx_tpu_torch.utils import spans
  except ImportError:
    return None
  counts = getattr(spans, "capsule_hull_fused_groups", None)
  if counts is None:
    return None
  fused, run = counts()
  if not run:
    return None
  return 100.0 * fused / run

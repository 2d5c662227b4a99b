"""The share of the Newton blocks run from a CUDA graph, in %: the
program's counter ``myosuite_mjx_tpu_torch.utils.spans.newton_graph_blocks()``
over the traced window's solves, 100 x (blocks replayed from a graph) /
(all blocks). Moves ``physics_steps_per_s``: a replayed block costs the
host one launch where an eager one costs some hundreds. None outside a
traced window, where the program has no such counter, or where it ran no
block."""


def read(ctx: dict):
  if not ctx.get("trace"):
    return None
  try:
    from myosuite_mjx_tpu_torch.utils import spans
  except ImportError:
    return None
  counts = getattr(spans, "newton_graph_blocks", None)
  if counts is None:
    return None
  graphed, run = counts()
  if not run:
    return None
  return 100.0 * graphed / run

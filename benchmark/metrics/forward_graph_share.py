"""The share of the forward passes on the card served by CUDA graph
replays, in %: the program's counter
``myosuite_mjx_tpu_torch.utils.spans.forward_graph_passes()`` over the
traced window, 100 x (passes whose stages from ``fwd_position`` to
``make_efc`` replayed graphs) / (all forward passes on the card). Moves
``physics_steps_per_s``: a replayed pass costs the host a launch or two
where an eager one costs some thousands. None outside a traced window,
where the program has no such counter, or where it ran no forward pass on
the card."""


def read(ctx: dict):
  if not ctx.get("trace"):
    return None
  try:
    from myosuite_mjx_tpu_torch.utils import spans
  except ImportError:
    return None
  counts = getattr(spans, "forward_graph_passes", None)
  if counts is None:
    return None
  graphed, run = counts()
  if not run:
    return None
  return 100.0 * graphed / run

"""The share of the mesh narrowphase's slots that end as a force, in %: the
program's counter ``myosuite_mjx_tpu_torch.utils.spans.mesh_contact_use()``
over the traced window's solves (the resets' included), 100 x (kept
contacts of a mesh pair holding a nonzero normal force, summed over envs
and solves) / (B x the narrowphase's slots of the pairs with a mesh,
summed over solves). The rest is hull work (golden-section searches,
point-in-hull tests, the plane's vertex sort) that no force reads. Moves
``physics_steps_per_s``. None outside a traced window, where the program
has no such counter, or where it kept no solve (a scene without a
mesh)."""


def read(ctx: dict):
  if not ctx.get("trace"):
    return None
  try:
    from myosuite_mjx_tpu_torch.utils import spans
  except ImportError:
    return None
  counts = getattr(spans, "mesh_contact_use", None)
  if counts is None:
    return None
  used, computed = counts()
  if not computed:
    return None
  return 100.0 * used / computed

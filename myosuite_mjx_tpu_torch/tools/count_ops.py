"""How many PyTorch ops one physics substep of a scene dispatches.

    python -m myosuite_mjx_tpu_torch.tools.count_ops hand23 hand23_hold \
        prims36 legs80Walk-v0 [--device cpu] [--batch 4]

Each name is a scene of ``assets/`` (``<name>.npz``) or a task id of the
registry (``envs.registry_ids()``). For each it prints the ops of one
``forward.step`` (``full_data=False``, as the frame-skip loop's
substeps), of its ``collision.contacts`` call, and of each narrowphase
type group; for a task id the state is a reset of the task (its overlay,
its mocap bodies), and it also prints the ops of one control step
(``autoreset_step``: ``frame_skip`` substeps, obs, reward and the folded-in
reset). Views (reshape, expand, slicing, transposes) are not counted: they
launch no kernel. On the card nearly every counted op is one kernel
launch, so the count predicts the host's dispatch cost without a card;
``tools/profile_step.py`` measures the launches there.
"""
from __future__ import annotations

import argparse
import re

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from myosuite_mjx_tpu_torch import envs
from myosuite_mjx_tpu_torch.engine import collision, forward
from myosuite_mjx_tpu_torch.engine import data as data_mod
from myosuite_mjx_tpu_torch.engine import model as model_mod
from myosuite_mjx_tpu_torch.envs.registry import asset

_VIEWS = {torch.ops.aten.view, torch.ops.aten._unsafe_view,
          torch.ops.aten.expand, torch.ops.aten.select, torch.ops.aten.slice,
          torch.ops.aten.unsqueeze, torch.ops.aten.squeeze, torch.ops.aten.t,
          torch.ops.aten.transpose, torch.ops.aten.permute,
          torch.ops.aten.detach, torch.ops.aten.alias}


class OpCounter(TorchDispatchMode):
  """Counts the non-view aten ops dispatched inside it."""

  def __init__(self):
    super().__init__()
    self.ops = 0

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    if func.overloadpacket not in _VIEWS:
      self.ops += 1
    return func(*args, **(kwargs or {}))


def count(fn) -> int:
  with OpCounter() as c:
    fn()
  return c.ops


def main(argv=None) -> None:
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("scenes", nargs="+",
                  help="npz names in assets/ or task ids")
  ap.add_argument("--device", default="cuda")
  ap.add_argument("--batch", type=int, default=4)
  args = ap.parse_args(argv)
  for name in args.scenes:
    env = None
    if re.search(r"-v\d+$", name):
      env = envs.make(name)
      dm = env.device_model(args.device)
      st = env.reset(args.batch, args.device,
                     torch.Generator(args.device).manual_seed(0))
      d = st.data
    else:
      dm = model_mod.DeviceModel(model_mod.load_npz(asset(f"{name}.npz")),
                                 torch.float32, args.device)
      d = forward.step(dm, data_mod.make_data(dm, args.batch, torch.float32,
                                              args.device))
    line = (f"{name}: substep {count(lambda: forward.step(dm, d, False))} "
            f"ops, contacts {count(lambda: collision.contacts(dm, d))}")
    if env is not None:
      action = torch.zeros((args.batch, env.action_dim), device=args.device)
      line += (f", control step (frame_skip {env.frame_skip}) "
               f"{count(lambda: env.autoreset_step(st, action))}")
    print(line)
    spec = collision.collision_spec(dm)
    for g in spec.groups:
      s1 = g.size1.expand(args.batch, -1, -1)
      s2 = g.size2.expand(args.batch, -1, -1)
      ops = count(lambda: collision.group_fn(g, d)(
          d.geom_xpos[:, g.g1], d.geom_xmat[:, g.g1], s1,
          d.geom_xpos[:, g.g2], d.geom_xmat[:, g.g2], s2))
      names = "-".join(model_mod.GeomType(t).name for t in g.types)
      print(f"  {names}: {ops} ops")


if __name__ == "__main__":
  main()

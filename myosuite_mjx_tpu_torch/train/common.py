"""What the learners share: flax-compatible layers, optax-compatible Adam,
the metrics' host copy, and the carry of flax parameters and optax Adam
states (leaves as numpy) into the port.

The JAX package's learners build their nets with flax and their
optimizers with optax; the port's nets are ``nn.Linear`` stacks that
name their layers as flax does (``flax_dense``), so that a JAX state can
be carried in and a port state written out as flax's tree.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
from torch import nn

# the std of a unit normal truncated at +-2: flax's lecun_normal divides by
# it so that the truncated draw keeps variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def dense(fan_in: int, fan_out: int, generator: torch.Generator,
          dtype: torch.dtype, device) -> nn.Linear:
  """``nn.Linear`` initialised as flax's ``nn.Dense``: weight from
  ``lecun_normal`` (a normal of std sqrt(1/fan_in)/0.8796, cut at +-2 std),
  bias zero. Torch's own default init is different."""
  layer = nn.utils.skip_init(nn.Linear, fan_in, fan_out, dtype=dtype,
                             device=device)
  std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
  with torch.no_grad():
    nn.init.trunc_normal_(layer.weight, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)
    layer.bias.zero_()
  return layer


def mlp(sizes: list, generator, dtype, device) -> nn.ModuleList:
  """``dense`` layers sizes[0] -> sizes[1] -> ... -> sizes[-1]."""
  return nn.ModuleList(dense(a, b, generator, dtype, device)
                       for a, b in zip(sizes[:-1], sizes[1:]))


def adam(module, lr: float) -> torch.optim.Adam:
  """``torch.optim.Adam`` over a module's parameters (or a list of
  tensors) with optax.adam's defaults (betas 0.9/0.999, eps 1e-8 outside
  the square root) and its state made at once, as optax's ``init`` does,
  so that a fresh state can be checkpointed or carried."""
  params = list(module.parameters() if isinstance(module, nn.Module)
                else module)
  opt = torch.optim.Adam(params, lr=lr, eps=1e-8)
  for p in params:
    opt.state[p] = {"step": torch.zeros((), dtype=torch.float32),
                    "exp_avg": torch.zeros_like(p),
                    "exp_avg_sq": torch.zeros_like(p)}
  return opt


class BatchReductions:
  """The reductions of a learner over its whole training batch. In one
  process the batch is all here, so they are the plain ones; the
  data-parallel learners (``parallel/mesh.py``) reduce them across
  processes."""

  def batch_sum(self, x: torch.Tensor) -> torch.Tensor:
    """``x``, a sum over this process's part of the batch, summed over
    the whole batch."""
    return x

  def batch_mean(self, x: torch.Tensor) -> torch.Tensor:
    """``x``, a mean over this process's part of the batch, averaged over
    the whole batch (every process holds an equal part)."""
    return x

  def moments(self, x: torch.Tensor):
    """(mean, std with ddof 0) over every entry of ``x`` in the batch."""
    return x.mean(), torch.sqrt(x.var(correction=0))

  def norm_update(self, norm, batch: torch.Tensor):
    """``norm`` (a ``ppo.RunningNorm``) updated with the batch's samples."""
    return norm.update(batch)

  def sync_grads(self, params: list) -> None:
    """Make each parameter's ``.grad`` the whole batch's gradient."""

  def gather_envs(self, x: torch.Tensor) -> torch.Tensor:
    """``x`` [T, n, ...] of this process's n envs as the whole batch's
    [T, N, ...], envs in the single-process order."""
    return x


def metrics_to_host(metrics: dict) -> dict:
  """One device-to-host copy for a dict of scalar tensors."""
  vals = torch.stack([v.detach().to(torch.float64).reshape(())
                      for v in metrics.values()]).cpu().tolist()
  return dict(zip(metrics, vals))


def _flax_leaves(net: nn.Module):
  """(tensor, key path in the flax params, transposed) for every parameter:
  a flax Dense kernel is [in, out], an ``nn.Linear`` weight [out, in]."""
  for name, layer in net.flax_dense():
    yield layer.weight, (name, "kernel"), True
    yield layer.bias, (name, "bias"), False
  if hasattr(net, "log_std"):
    yield net.log_std, ("log_std",), False


def _get(tree: dict, path: tuple, transposed: bool) -> torch.Tensor:
  """The leaf at ``path`` as a fresh C-ordered tensor, transposed if asked."""
  for k in path:
    tree = tree[k]
  x = np.asarray(tree)
  return torch.as_tensor(np.array(x.T if transposed else x, order="C"))


def flax_params(net: nn.Module) -> dict:
  """The net's parameters as the JAX package's flax tree of numpy arrays."""
  out: dict = {}
  for p, path, transposed in _flax_leaves(net):
    node = out
    for k in path[:-1]:
      node = node.setdefault(k, {})
    x = p.detach().cpu().numpy()
    node[path[-1]] = x.T.copy() if transposed else x
  return {"params": out}


def load_flax_params(net: nn.Module, tree: dict) -> nn.Module:
  """Copy a flax params tree (``{"params": ...}``, numpy) into the net."""
  with torch.no_grad():
    for p, path, transposed in _flax_leaves(net):
      p.copy_(_get(tree["params"], path, transposed))
  return net


def _adam_state(opt_state) -> Any:
  """The ``ScaleByAdamState`` inside an optax (chained) state."""
  if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
    return opt_state
  if isinstance(opt_state, (tuple, list)):
    for s in opt_state:
      found = _adam_state(s)
      if found is not None:
        return found
  return None


def load_adam_state(opt: torch.optim.Adam, net: nn.Module, opt_state) -> None:
  """optax adam's (count, mu, nu) -> torch Adam's (step, exp_avg,
  exp_avg_sq) for every parameter of ``net``."""
  st = _adam_state(opt_state)
  count = float(np.asarray(st.count))
  with torch.no_grad():
    for p, path, transposed in _flax_leaves(net):
      opt.state[p] = {
          "step": torch.tensor(count, dtype=torch.float32),
          "exp_avg": _get(st.mu["params"], path, transposed).to(p),
          "exp_avg_sq": _get(st.nu["params"], path, transposed).to(p)}

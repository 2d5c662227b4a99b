"""Checkpoint/resume for training state, with ``torch.save``/``torch.load``.

Counterpart of ``myosuite_mjx_tpu/train/checkpoint.py`` (orbax there). A
training state (``NPGState``, ``TrainState`` or any tree of dataclasses,
dicts, lists, tensors, ``nn.Module``s, optimizers and generators) is saved
as one nested dict of CPU tensors and plain values: a module as its
``state_dict``, an optimizer as its per-parameter state, a generator as
its ``get_state()``. Restoring into a template of the same structure makes
resume exact; a tensor that requires grad (SAC's ``log_alpha``) is loaded
in place, so that the optimizer holding it keeps it.
"""
from __future__ import annotations

import dataclasses
import os
import pickle

import torch
from torch import nn

from myosuite_mjx_tpu_torch.train.common import flax_params

_MISSING = object()


def _to_tree(obj):
  """A copy of ``obj`` as nested dicts of CPU tensors and plain values."""
  if isinstance(obj, torch.Tensor):
    return obj.detach().cpu().clone()
  if isinstance(obj, nn.Module):
    return {k: _to_tree(v) for k, v in obj.state_dict().items()}
  if isinstance(obj, torch.optim.Optimizer):
    return {"state": {str(i): _to_tree(obj.state[p])
                      for i, p in enumerate(_opt_params(obj))}}
  if isinstance(obj, torch.Generator):
    return obj.get_state()
  if dataclasses.is_dataclass(obj):
    return {f.name: _to_tree(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}
  if isinstance(obj, dict):
    return {str(k): _to_tree(v) for k, v in obj.items()}
  if isinstance(obj, (list, tuple)):
    return {str(i): _to_tree(v) for i, v in enumerate(obj)}
  return obj


def _opt_params(opt: torch.optim.Optimizer) -> list:
  return [p for group in opt.param_groups for p in group["params"]]


def save(path: str, train_state) -> None:
  path = os.path.abspath(path)
  os.makedirs(os.path.dirname(path), exist_ok=True)
  torch.save(_to_tree(train_state), path)


def _child(saved, key: str):
  return saved.get(key, _MISSING) if isinstance(saved, dict) else _MISSING


def _restore(template, saved, path: str, params: bool, missing: list,
             pending: list):
  """The template with every leaf the checkpoint holds put in; leaves it
  lacks are recorded in ``missing`` (with whether they are parameter
  leaves: a module's weights or an optimizer's state of them). In-place
  loads into modules, optimizers and generators are queued in ``pending``
  and run only once the whole tree has been checked."""
  def child(t, key, is_param=params):
    return _restore(t, _child(saved, key), f"{path}.{key}", is_param,
                    missing, pending)

  if isinstance(template, torch.Tensor):
    if saved is _MISSING:
      missing.append((path, params))
      return template
    if not isinstance(saved, torch.Tensor) or (
        saved.shape != template.shape or saved.dtype != template.dtype):
      raise ValueError(
          f"checkpoint leaf {path}: {getattr(saved, 'dtype', type(saved))} "
          f"{tuple(getattr(saved, 'shape', ()))}, template {template.dtype} "
          f"{tuple(template.shape)}")
    if template.requires_grad:
      # a trained leaf outside any module (SAC's log_alpha): an optimizer
      # holds this very tensor, so load into it in place
      def load_leaf():
        with torch.no_grad():
          template.copy_(saved)
      pending.append(load_leaf)
      return template
    return saved.to(template.device)
  if isinstance(template, nn.Module):
    sd = {k: child(v, k, True) for k, v in template.state_dict().items()}
    pending.append(lambda: template.load_state_dict(sd))
    return template
  if isinstance(template, torch.optim.Optimizer):
    state = _child(saved, "state")
    new = {}
    for i, p in enumerate(_opt_params(template)):
      st = _child(state, str(i))
      new[i] = {k: _restore(v, _child(st, k), f"{path}.state.{i}.{k}", True,
                            missing, pending)
                for k, v in template.state[p].items()}

    def load_opt():
      sd = template.state_dict()
      sd["state"] = new
      template.load_state_dict(sd)
    pending.append(load_opt)
    return template
  if isinstance(template, torch.Generator):
    if saved is _MISSING:
      missing.append((path, params))
    else:
      pending.append(lambda: template.set_state(saved))
    return template
  if dataclasses.is_dataclass(template):
    return dataclasses.replace(template, **{
        f.name: child(getattr(template, f.name), f.name)
        for f in dataclasses.fields(template) if f.init})
  if isinstance(template, dict):
    return {k: child(v, str(k)) for k, v in template.items()}
  if isinstance(template, (list, tuple)):
    return type(template)(child(v, str(i)) for i, v in enumerate(template))
  if saved is _MISSING:
    missing.append((path, params))
    return template
  return saved


def restore(path: str, template):
  """Restore into the structure of ``template``; returns the restored tree.

  Every restored tensor must match the template's shape and dtype. Leaves
  the template has and the checkpoint lacks (state that grew a field
  since the save) keep their template value; a missing parameter leaf
  raises, since that would silently reinitialize a layer. Modules,
  optimizers and generators in the template are loaded in place.
  """
  path = os.path.abspath(path)
  saved = torch.load(path, map_location="cpu", weights_only=True)
  missing: list = []
  pending: list = []
  restored = _restore(template, saved, "", False, missing, pending)
  lost = [p for p, is_param in missing if is_param]
  if lost:
    raise RuntimeError(
        f"checkpoint {path} is missing parameter leaves: {lost}")
  if missing:
    print(f"partial restore: keeping template values for "
          f"{[p for p, _ in missing]}")
  for load in pending:
    load()
  return restored


def save_params(path: str, params: nn.Module) -> None:
  """Policy-only export: a pickle of the net's parameters as the JAX
  package's flax tree of numpy arrays (what its ``save_params`` writes)."""
  with open(path, "wb") as f:
    pickle.dump(flax_params(params), f)

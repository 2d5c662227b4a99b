"""Task registry: task ids as data, with variants derived from them.

Counterpart of ``myosuite_mjx_tpu/envs/registry.py``. An entry is (env
class, kwargs); a variant clones an entry with a deep-merged kwargs
overlay; ``make`` builds (and caches) the env of an id.

``asset(relpath)`` resolves into the port's ``assets/`` directory, where
the exported ``.npz`` scenes live (``MYOSUITE_TORCH_ASSETS`` overrides
it): the card's machine has no MJCF compiler, so the port registers no
MJCF path.
"""
from __future__ import annotations

import copy
import os
from typing import Any

_REGISTRY: dict[str, tuple[type, dict]] = {}

ASSET_ROOT = os.environ.get(
    "MYOSUITE_TORCH_ASSETS",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "assets"))


def asset(relpath: str) -> str:
  return os.path.join(ASSET_ROOT, relpath)


def register(env_id: str, cls: type, kwargs: dict,
             max_episode_steps: int = 100):
  if env_id in _REGISTRY:
    raise ValueError(f"duplicate env id {env_id}")
  kw = dict(kwargs)
  kw.setdefault("horizon", max_episode_steps)
  _REGISTRY[env_id] = (cls, kw)


def registry_ids() -> list[str]:
  return sorted(_REGISTRY)


def deep_update(base: dict, overlay: dict) -> dict:
  out = copy.deepcopy(base)
  for k, v in overlay.items():
    if isinstance(v, dict) and isinstance(out.get(k), dict):
      out[k] = deep_update(out[k], v)
    else:
      out[k] = copy.deepcopy(v)
  return out


def register_env_variant(env_id: str, variant_id: str, variants: dict):
  """Clone a registered env with deep-merged kwarg overrides."""
  cls, kwargs = _REGISTRY[env_id]
  register(variant_id, cls, deep_update(kwargs, variants))
  return variant_id


_env_cache: dict[str, Any] = {}


def make(env_id: str, cache: bool = True, **overrides):
  """Build the env of a task id. Without overrides it is cached (envs are
  immutable task objects); overrides deep-merge into the kwargs and build
  a fresh env."""
  cls, kwargs = _REGISTRY[env_id]
  if overrides or not cache:
    return cls(**deep_update(kwargs, overrides))
  if env_id not in _env_cache:
    _env_cache[env_id] = cls(**kwargs)
  return _env_cache[env_id]

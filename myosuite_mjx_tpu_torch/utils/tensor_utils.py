"""Path and rollout tensor helpers, and the cosine of two vectors.

Counterpart of ``myosuite_mjx_tpu/utils/tensor_utils.py``. The path
helpers work on host-side rollout paths and stay numpy, as there.
``calculate_cosine`` is torch, batch-first over the last axis (several
task rewards use it on the env's device).
"""
from __future__ import annotations

import numpy as np
import torch


def calculate_cosine(vec1, vec2) -> torch.Tensor:
  """cos(theta) between (batches of) vectors over the last axis; 0 where
  either norm is 0."""
  vec1 = torch.as_tensor(vec1)
  vec2 = torch.as_tensor(vec2, dtype=vec1.dtype, device=vec1.device)
  norm_product = (torch.linalg.vector_norm(vec1, dim=-1)
                  * torch.linalg.vector_norm(vec2, dim=-1))
  dot = (vec1 * vec2).sum(-1)
  zero = norm_product == 0
  return torch.where(zero, torch.zeros_like(dot),
                     dot / torch.where(zero, torch.ones_like(norm_product),
                                       norm_product))


def flatten_tensors(tensors):
  if len(tensors) > 0:
    return np.concatenate([np.reshape(x, [-1]) for x in tensors])
  return np.asarray([])


def unflatten_tensors(flattened, tensor_shapes):
  tensor_sizes = list(map(np.prod, tensor_shapes))
  indices = np.cumsum(tensor_sizes)[:-1]
  return [np.reshape(chunk, shape) for chunk, shape in
          zip(np.split(flattened, indices), tensor_shapes)]


def pad_tensor(x, max_len, mode="zero"):
  padding = np.zeros_like(x[0]) if mode == "zero" else x[-1]
  return np.concatenate(
      [x, np.tile(padding, (max_len - len(x),) + (1,) * np.ndim(x[0]))])


def pad_tensor_n(xs, max_len):
  ret = np.zeros((len(xs), max_len) + xs[0].shape[1:], dtype=xs[0].dtype)
  for idx, x in enumerate(xs):
    ret[idx][:len(x)] = x
  return ret


def pad_tensor_dict(tensor_dict, max_len, mode="zero"):
  return {k: (pad_tensor_dict(v, max_len, mode) if isinstance(v, dict)
              else pad_tensor(v, max_len, mode))
          for k, v in tensor_dict.items()}


def stack_tensor_list(tensor_list):
  return np.array(tensor_list)


def stack_tensor_dict_list(tensor_dict_list):
  """List of nested dicts -> nested dict of stacked arrays."""
  ret = {}
  for k, example in tensor_dict_list[0].items():
    vals = [d[k] for d in tensor_dict_list]
    ret[k] = (stack_tensor_dict_list(vals) if isinstance(example, dict)
              else stack_tensor_list(vals))
  return ret


def concat_tensor_list(tensor_list):
  return np.concatenate(tensor_list, axis=0)


def concat_tensor_dict_list(tensor_dict_list):
  ret = {}
  for k, example in tensor_dict_list[0].items():
    vals = [d[k] for d in tensor_dict_list]
    ret[k] = (concat_tensor_dict_list(vals) if isinstance(example, dict)
              else concat_tensor_list(vals))
  return ret


def split_tensor_dict_list(tensor_dict):
  """Nested dict of arrays -> list of nested dicts (inverse of stack)."""
  ret = None
  for k, val in tensor_dict.items():
    vals = split_tensor_dict_list(val) if isinstance(val, dict) else val
    if ret is None:
      ret = [{k: v} for v in vals]
    else:
      for d, v in zip(ret, vals):
        d[k] = v
  return ret


def truncate_tensor_list(tensor_list, truncated_len):
  return tensor_list[:truncated_len]


def truncate_tensor_dict(tensor_dict, truncated_len):
  return {k: (truncate_tensor_dict(v, truncated_len) if isinstance(v, dict)
              else truncate_tensor_list(v, truncated_len))
          for k, v in tensor_dict.items()}

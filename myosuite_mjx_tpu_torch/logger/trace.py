"""Trace: grouped rollout datasets (h5 / pickle).

Counterpart of ``myosuite_mjx_tpu/logger/trace.py``: named trial groups of
keyed time series, append / stack / verify, and h5 and pickle round trips.
Values are kept as numpy arrays on the host; a torch tensor (on any
device) is copied to the host when it is appended. ``h5py`` and
``imageio`` are imported inside the functions that use them, so the
pickle path needs neither. A batched rollout lands here through
``append_batched_rollout`` (one group per env).
"""
from __future__ import annotations

import pickle

import numpy as np
import torch


def _np(x) -> np.ndarray:
  if isinstance(x, torch.Tensor):
    return x.detach().cpu().numpy()
  return np.asarray(x)


class Trace:
  def __init__(self, name: str = "Trace"):
    self.name = name
    self.root = {name: {}}
    self.trace = self.root[name]
    self.index = 0

  # ---- group management --------------------------------------------------

  def create_group(self, name: str):
    self.trace[name] = {}
    self.index = len(self.trace)
    return self.trace[name]

  def create_dataset(self, group_key: str, dataset_key: str,
                     dataset_val=None):
    if group_key not in self.trace:
      self.create_group(group_key)
    self.trace[group_key][dataset_key] = (
        [] if dataset_val is None else [_np(dataset_val)])

  # ---- appending ---------------------------------------------------------

  def append_datum(self, group_key: str, dataset_key: str, dataset_val):
    if group_key not in self.trace:
      self.create_group(group_key)
    group = self.trace[group_key]
    if dataset_key not in group:
      group[dataset_key] = []
    group[dataset_key].append(_np(dataset_val))

  def append_datums(self, group_key: str, **dataset_vals):
    for k, v in dataset_vals.items():
      self.append_datum(group_key, k, v)

  def append_batched_rollout(self, prefix: str, **stacked):
    """Record a [T, B, ...] batched rollout as B groups of T-step series."""
    stacked = {k: _np(v) for k, v in stacked.items()}
    B = next(iter(stacked.values())).shape[1]
    for b in range(B):
      g = f"{prefix}{b}"
      for k, v in stacked.items():
        self.trace.setdefault(g, {})[k] = list(v[:, b])

  # ---- verification / stacking ------------------------------------------

  def verify(self) -> bool:
    """All datasets within a group share horizon length."""
    for group in self.trace.values():
      lens = {len(v) for v in group.values()}
      if len(lens) > 1:
        return False
    return True

  def stack(self):
    for gname, group in self.trace.items():
      for k in list(group):
        group[k] = np.stack([np.asarray(x) for x in group[k]])

  def flatten(self) -> dict:
    out = {}
    for gname, group in self.trace.items():
      for k, v in group.items():
        out[f"{gname}/{k}"] = v
    return out

  # ---- video -------------------------------------------------------------

  def render(self, output_dir: str, groups="all", datasets=("rgb",),
             fps: int = 25, input_fps: int = 25):
    """Stitch logged image datasets into videos, one file per
    (group, dataset), through ``imageio``. A dataset qualifies when its
    frames are [T, H, W, 3] uint8-able. Falls back to gif when no mp4
    backend exists. Returns written paths."""
    import os

    import imageio
    os.makedirs(output_dir, exist_ok=True)
    gkeys = list(self.trace) if groups == "all" else list(groups)
    written = []
    for g in gkeys:
      for dkey in datasets:
        if dkey not in self.trace[g]:
          continue
        frames = np.asarray(self.trace[g][dkey])
        if frames.ndim != 4 or frames.shape[-1] != 3:
          raise ValueError(
              f"dataset {g}/{dkey} is not [T, H, W, 3] rgb frames")
        path = os.path.join(output_dir, f"{self.name}_{g}_{dkey}.mp4")
        try:
          writer = imageio.get_writer(path, fps=fps)
        except ValueError:
          path = os.path.splitext(path)[0] + ".gif"
          writer = imageio.get_writer(path, fps=fps)
        step = max(1, input_fps // fps)
        with writer as w:
          for f in frames[::step]:
            w.append_data(np.asarray(f, np.uint8))
        written.append(path)
    return written

  # ---- io ----------------------------------------------------------------

  def save(self, path: str, verify: bool = True):
    if verify:
      if not self.verify():
        raise ValueError("inconsistent horizons across datasets")
    if path.endswith((".h5", ".hdf5")):
      import h5py
      with h5py.File(path, "w") as f:
        root = f.create_group(self.name)
        for gname, group in self.trace.items():
          hg = root.create_group(gname)
          for k, v in group.items():
            hg.create_dataset(k, data=np.asarray(v))
    elif path.endswith((".pkl", ".pickle")):
      with open(path, "wb") as f:
        pickle.dump(self.root, f)
    else:
      raise ValueError(f"unknown trace format: {path}")

  @classmethod
  def load(cls, path: str) -> "Trace":
    if path.endswith((".h5", ".hdf5")):
      import h5py
      with h5py.File(path, "r") as f:
        name = list(f.keys())[0]
        t = cls(name)
        for gname in f[name]:
          t.trace[gname] = {
              k: np.asarray(f[name][gname][k]) for k in f[name][gname]}
    elif path.endswith((".pkl", ".pickle")):
      with open(path, "rb") as f:
        root = pickle.load(f)
      name = list(root.keys())[0]
      t = cls(name)
      t.root = root
      t.trace = root[name]
    else:
      raise ValueError(f"unknown trace format: {path}")
    return t

  def __repr__(self):
    lines = [f"Trace: {self.name}"]
    for gname, group in self.trace.items():
      keys = {k: np.asarray(v).shape if not isinstance(v, list)
              else (len(v),) for k, v in group.items()}
      lines.append(f"  {gname}: {keys}")
    return "\n".join(lines)

"""Plain reference, frozen from the port's ``engine/model.py`` and
importing nothing of it.

Physics model of the port: host constants and their device copy.

The MJCF compiler needs ``mujoco``, which the GPU machine does not have. So
a scene is compiled once on a host with the JAX package's
``engine/model.load_model`` and shipped as an ``.npz`` (the fixtures by
``python tests/torch_parity.py --export``, the one place that imports both
packages).
``load_npz`` reads it back into a ``Model``: every field of the reference
``Model`` as numpy, ``Option`` as a dataclass and ``names`` as a dict.

``DeviceModel`` is the part the step reads: every array field as a buffer on
one device, floats cast once to the working dtype, integers as ``long`` and
flags as ``bool``. The static layouts each engine module precomputes (tree
levels, tendon groups, collision slots, limit rows) are built once per
``DeviceModel`` through ``spec`` and cached on it.
"""
from __future__ import annotations

import dataclasses
import enum
import json
import os
from typing import Any, Callable

import numpy as np
import torch
from torch import nn


class JointType(enum.IntEnum):
  FREE = 0
  BALL = 1
  SLIDE = 2
  HINGE = 3


class GeomType(enum.IntEnum):
  PLANE = 0
  HFIELD = 1
  SPHERE = 2
  CAPSULE = 3
  ELLIPSOID = 4
  CYLINDER = 5
  BOX = 6
  MESH = 7


class TrnType(enum.IntEnum):
  JOINT = 0
  JOINTINPARENT = 1
  SLIDERCRANK = 2
  TENDON = 3
  SITE = 4
  BODY = 5


class DynType(enum.IntEnum):
  NONE = 0
  INTEGRATOR = 1
  FILTER = 2
  FILTEREXACT = 3
  MUSCLE = 4


class GainType(enum.IntEnum):
  FIXED = 0
  AFFINE = 1
  MUSCLE = 2


class BiasType(enum.IntEnum):
  NONE = 0
  AFFINE = 1
  MUSCLE = 2


class WrapType(enum.IntEnum):
  NONE = 0
  JOINT = 1
  PULLEY = 2
  SITE = 3
  SPHERE = 4
  CYLINDER = 5


class IntegratorType(enum.IntEnum):
  EULER = 0
  RK4 = 1
  IMPLICIT = 2
  IMPLICITFAST = 3


class ConeType(enum.IntEnum):
  PYRAMIDAL = 0
  ELLIPTIC = 1


class EqType(enum.IntEnum):
  CONNECT = 0
  WELD = 1
  JOINT = 2
  TENDON = 3


class SensorType(enum.IntEnum):
  TOUCH = 0
  ACCELEROMETER = 1
  VELOCIMETER = 2
  GYRO = 3
  FORCE = 4
  TORQUE = 5
  MAGNETOMETER = 6
  RANGEFINDER = 7
  JOINTPOS = 8
  JOINTVEL = 9
  TENDONPOS = 10
  TENDONVEL = 11
  ACTUATORPOS = 12
  ACTUATORVEL = 13
  ACTUATORFRC = 14


# mjtDisableBit values (bitmask in opt.disableflags)
DSBL_CONSTRAINT = 1 << 0
DSBL_EQUALITY = 1 << 1
DSBL_FRICTIONLOSS = 1 << 2
DSBL_LIMIT = 1 << 3
DSBL_CONTACT = 1 << 4
DSBL_PASSIVE = 1 << 5
DSBL_GRAVITY = 1 << 6
DSBL_CLAMPCTRL = 1 << 7
DSBL_ACTUATION = 1 << 10


@dataclasses.dataclass(frozen=True)
class Option:
  """Simulation options (the mjOption fields the pipeline consumes)."""
  timestep: float
  gravity: np.ndarray
  integrator: int
  cone: int
  solver_iterations: int
  ls_iterations: int
  tolerance: float
  ls_tolerance: float
  impratio: float
  disableflags: int
  density: float
  viscosity: float
  meaninertia: float = 1.0


# fields that hold a dict {mesh id: array} rather than one array
_DICT_FIELDS = ("mesh_hull_tris", "mesh_hull_verts")


class Model:
  """Host model: the reference compiler's fields as numpy arrays and ints.

  Sizes (``nq``, ``nv``, ...) are ints, ``opt`` an ``Option``, ``names`` a
  {kind: {name: id}} dict, the mesh hull fields {mesh id: array} dicts and
  every other field a numpy array.
  """

  def __init__(self, **fields: Any):
    self.__dict__.update(fields)

  def field_names(self) -> list[str]:
    return list(self.__dict__)

  def name2id(self, kind: str, name: str) -> int:
    try:
      return self.names[kind][name]
    except KeyError:
      raise KeyError(f"no {kind} named {name!r}") from None


def from_reference(m) -> Model:
  """Carry the JAX package's numpy ``Model`` into the port, field by field."""
  fields = {f.name: getattr(m, f.name) for f in dataclasses.fields(m)}
  fields["opt"] = Option(**{f.name: getattr(m.opt, f.name)
                            for f in dataclasses.fields(m.opt)})
  return Model(**fields)


def to_npz_payload(m: Model) -> dict[str, np.ndarray]:
  """Flatten a Model into the arrays an ``.npz`` holds (see ``load_npz``)."""
  out: dict[str, np.ndarray] = {}
  for name, value in m.__dict__.items():
    if name == "opt":
      opt = dataclasses.asdict(value)
      opt["gravity"] = np.asarray(opt["gravity"]).tolist()
      out["opt"] = np.array(json.dumps(opt, sort_keys=True))
    elif name == "names":
      out["names"] = np.array(json.dumps(value, sort_keys=True))
    elif name in _DICT_FIELDS:
      out[f"{name}/__dict__"] = np.array(0)
      for key, arr in value.items():
        out[f"{name}/{int(key)}"] = np.asarray(arr)
    elif isinstance(value, (int, np.integer)):
      out[name] = np.array(int(value))
    else:
      out[name] = np.asarray(value)
  return out


def load_npz(path: str) -> Model:
  """Read a Model written from ``to_npz_payload`` (see the module note)."""
  if not os.path.exists(path):
    raise FileNotFoundError(f"no model file at {path!r}")
  fields: dict[str, Any] = {name: {} for name in _DICT_FIELDS}
  with np.load(path, allow_pickle=False) as z:
    for key in z.files:
      arr = z[key]
      if key == "opt":
        opt = json.loads(str(arr))
        opt["gravity"] = np.asarray(opt["gravity"], np.float64)
        fields["opt"] = Option(**opt)
      elif key == "names":
        fields["names"] = json.loads(str(arr))
      elif "/" in key:
        name, sub = key.split("/")
        if sub != "__dict__":
          fields[name][int(sub)] = arr
      elif arr.ndim == 0:
        fields[key] = int(arr)
      else:
        fields[key] = arr
  return Model(**fields)


class DeviceModel(nn.Module):
  """The model's constants on one device, read by every engine stage.

  Float fields are cast once to ``dtype``; integer fields become ``long``
  and boolean fields ``bool``. ``host`` keeps the numpy Model for the static
  decisions (sizes, types, layouts) made while building specs. The specs
  are built on the device given here, so build a new DeviceModel to move a
  model rather than calling ``.to``.
  """

  def __init__(self, model: Model, dtype: torch.dtype = torch.float32,
               device: str | torch.device = "cuda"):
    super().__init__()
    _check_supported(model)
    self.host = model
    self.dtype = dtype
    self.device = torch.device(device)
    self.opt = model.opt
    self._specs: dict[str, Any] = {}
    for name, value in model.__dict__.items():
      if isinstance(value, (int, np.integer)):
        setattr(self, name, int(value))
      elif isinstance(value, np.ndarray):
        self.register_buffer(name, _to_tensor(value, dtype, self.device),
                             persistent=False)

  def tensor(self, x, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A host constant on this model's device (floats in the work dtype)."""
    return _to_tensor(np.asarray(x), dtype, self.device,
                      default_float=self.dtype)

  def spec(self, name: str, builder: Callable[["DeviceModel"], Any]):
    """Static layout ``builder(self)``, built once and cached by name."""
    if name not in self._specs:
      self._specs[name] = builder(self)
    return self._specs[name]


def _to_tensor(x: np.ndarray, dtype, device, default_float=None):
  if dtype is None or x.dtype.kind in "iub":
    if x.dtype.kind == "b":
      return torch.as_tensor(x, dtype=torch.bool, device=device)
    if x.dtype.kind in "iu":
      return torch.as_tensor(x.astype(np.int64), device=device)
    dtype = default_float
  return torch.as_tensor(np.asarray(x, np.float64), device=device).to(dtype)


def _check_supported(m: Model) -> None:
  """Raise for model features whose engine paths are not ported yet.

  Every joint type, mocap bodies and joint and tendon equalities are
  ported. What the JAX package refuses when it traces the step is refused
  here, when the model is loaded: limits on ball joints and equalities of
  another type (connect, weld; its ``engine/constraint.py``), and joint
  transmission and springs on ball and free joints (its
  ``engine/forward.py``). A colliding mesh whose convex hull has no
  triangles is refused too: the reference's mesh pairs cannot collide it.
  """
  jt = np.asarray(m.jnt_type)
  quat_joint = (jt == JointType.BALL) | (jt == JointType.FREE)
  if np.any(quat_joint & np.asarray(m.jnt_limited, bool)):
    raise NotImplementedError("ball joint limits")
  if np.any(quat_joint & (np.asarray(m.jnt_stiffness) != 0.0)):
    raise NotImplementedError("spring on ball/free joint")
  trn_joint = np.asarray(m.actuator_trntype) == TrnType.JOINT
  if np.any(quat_joint[np.asarray(m.actuator_trnid)[trn_joint, 0]]):
    raise NotImplementedError("joint transmission on ball/free joints")
  for e in range(m.neq):
    if int(m.eq_type[e]) not in (EqType.JOINT, EqType.TENDON):
      raise NotImplementedError(f"equality type {int(m.eq_type[e])}")
  for mid, tris in getattr(m, "mesh_hull_tris", {}).items():
    if len(tris) == 0:
      geoms = [g for g in range(m.ngeom) if int(m.geom_dataid[g]) == mid
               and int(m.geom_type[g]) == GeomType.MESH]
      raise ValueError(
          f"mesh {mid} (geoms {geoms}) collides, but its convex hull has "
          f"no triangles (a flat or degenerate mesh): the mesh pairs "
          f"cannot collide it")
  if int(m.opt.integrator) != IntegratorType.EULER:
    raise NotImplementedError(f"integrator {int(m.opt.integrator)}")
  if int(m.opt.cone) != ConeType.PYRAMIDAL:
    raise NotImplementedError("elliptic friction cones are not ported")

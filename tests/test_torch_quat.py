"""Quaternion math parity: every function of the port's ``ops/quat.py``
against the JAX package's ``ops/quat.py`` on the same random inputs from a
numpy seed, float64, batch [3, 5] (rtol 1e-12, atol 1e-12)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close
from myosuite_mjx_tpu.ops import quat as jq
from myosuite_mjx_tpu_torch.ops import quat as tq

TOL = dict(rtol=1e-12, atol=1e-12)
SHAPE = (3, 5)


def _inputs(seed: int) -> dict:
  rng = np.random.default_rng(seed)
  q = rng.normal(size=SHAPE + (4,))
  unit = q / np.linalg.norm(q, axis=-1, keepdims=True)
  # a quarter of the rotations past pi, so quat_to_vel's wrap is taken
  unit[0, :2] *= -1
  v = rng.normal(size=SHAPE + (3,))
  euler = rng.uniform(-np.pi, np.pi, SHAPE + (3,))
  euler[1, 0, 1] = np.pi / 2           # gimbal lock: mat_to_euler's branch
  axis = v / np.linalg.norm(v, axis=-1, keepdims=True)
  # |a_y| past 0.9 for one row: orthogonals takes its other axis
  axis[2, 0] = np.array([0.1, 0.99, 0.0]) / np.linalg.norm([0.1, 0.99, 0.0])
  ident = unit.copy()
  ident[2, 4] = [1.0, 0.0, 0.0, 0.0]   # quat_to_axis_angle's fixed axis
  return dict(q=q, unit=unit, unit2=rng.normal(size=SHAPE + (4,)), v=v,
              euler=euler, axis=axis, angle=rng.uniform(-4, 4, SHAPE),
              omega=rng.normal(size=SHAPE + (3,)), ident=ident,
              dt=0.02)


def _unit2(x):
  return x["unit2"] / np.linalg.norm(x["unit2"], axis=-1, keepdims=True)


# name -> the function's arguments from the inputs
CASES = {
    "normalize": lambda x: (x["q"],),
    "quat_identity": None,
    "quat_mul": lambda x: (x["unit"], _unit2(x)),
    "quat_conj": lambda x: (x["q"],),
    "quat_rotate": lambda x: (x["unit"], x["v"]),
    "quat_rotate_inv": lambda x: (x["unit"], x["v"]),
    "quat_to_mat": lambda x: (x["unit"],),
    "mat_to_quat": lambda x: (np.array(jq.quat_to_mat(x["unit"])),),
    "axis_angle_to_quat": lambda x: (x["axis"], x["angle"]),
    "quat_to_axis_angle": lambda x: (x["ident"],),
    "quat_to_vel": lambda x: (x["ident"], x["dt"]),
    "quat_sub": lambda x: (x["unit"], _unit2(x)),
    "quat_diff": lambda x: (x["unit"], _unit2(x)),
    "quat_diff_vel": lambda x: (x["unit"], _unit2(x), x["dt"]),
    "quat_integrate": lambda x: (x["unit"], x["omega"], x["dt"]),
    "euler_to_quat": lambda x: (x["euler"],),
    "euler_to_mat": lambda x: (x["euler"],),
    "mat_to_euler": lambda x: (np.array(jq.euler_to_mat(x["euler"])),),
    "quat_to_euler": lambda x: (x["unit"],),
    "euler_intrinsic_to_quat": lambda x: (x["euler"],),
    "quat_to_euler_intrinsic": lambda x: (x["unit"],),
    "cross_matrix": lambda x: (x["v"],),
    "orthogonals": lambda x: (x["axis"],),
}


def test_every_reference_function_is_covered():
  ref = {n for n, f in vars(jq).items()
         if callable(f) and not n.startswith("_")
         and getattr(f, "__module__", "") == jq.__name__}
  assert ref == set(CASES)
  assert len(CASES) == 23


def _conv(a, to_torch: bool):
  if isinstance(a, float):
    return a
  return torch.as_tensor(a) if to_torch else jnp.asarray(a)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_function_matches_jax(name, seed):
  if name == "quat_identity":
    ref = jq.quat_identity(SHAPE, dtype=jnp.float64)
    out = tq.quat_identity(SHAPE, dtype=torch.float64)
    assert_close(out, ref, **TOL)
    return
  args = CASES[name](_inputs(seed))
  ref = getattr(jq, name)(*[_conv(a, False) for a in args])
  out = getattr(tq, name)(*[_conv(a, True) for a in args])
  ref = ref if isinstance(ref, tuple) else (ref,)
  out = out if isinstance(out, tuple) else (out,)
  assert len(out) == len(ref)
  for k, (o, r) in enumerate(zip(out, ref)):
    assert o.dtype == torch.float64, name
    assert o.shape == tuple(r.shape), name
    assert_close(o, r, what=f"{name}[{k}]", **TOL)


def test_functions_broadcast_a_single_axis_over_a_batch():
  """A [G, 3] axis against a [B, G] angle, as the kinematics hands them."""
  axis = torch.tensor([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0]], dtype=torch.float64)
  angle = torch.linspace(-1, 1, 8, dtype=torch.float64).reshape(4, 2)
  q = tq.axis_angle_to_quat(axis, angle)
  assert q.shape == (4, 2, 4)
  assert_close(tq.quat_to_mat(q) @ tq.quat_to_mat(tq.quat_conj(q)),
               torch.eye(3, dtype=torch.float64).expand(4, 2, 3, 3), **TOL)

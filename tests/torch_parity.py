"""Shared helpers for the PyTorch port's parity tests.

Each test makes its inputs with numpy from a seed, feeds them to the JAX
reference (``myosuite_mjx_tpu``, float64 on the CPU) and to the port
(``myosuite_mjx_tpu_torch``), and compares field by field.
"""
from __future__ import annotations

import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the lane runs several xdist workers; one intra-op thread each
torch.set_num_threads(1)

from myosuite_mjx_tpu.engine import data as jdata  # noqa: E402
from myosuite_mjx_tpu.engine import model as jmodel  # noqa: E402
from myosuite_mjx_tpu_torch.assets.fixtures import hand_fixture_xml  # noqa: E402
from myosuite_mjx_tpu_torch.engine import data as tdata  # noqa: E402
from myosuite_mjx_tpu_torch.engine import model as tmodel  # noqa: E402
from myosuite_mjx_tpu_torch.envs.pose import HAND_POSE_FIXED  # noqa: E402

ASSETS = os.path.join(os.path.dirname(tmodel.__file__), os.pardir, "assets")
NPZ = {2: os.path.join(ASSETS, "hand11.npz"), 5: os.path.join(ASSETS,
                                                              "hand23.npz")}

# myoHandPoseFixed-v0's target joint values (MyoHand joint order)
HAND_TARGET = HAND_POSE_FIXED["target_jnt_value"]


def jax_model(digits: int):
  """The reference Model of the fixture, compiled from its XML."""
  return jmodel.load_model(hand_fixture_xml(digits), dtype=np.float64)


def port_model(digits: int, dtype=torch.float64) -> tmodel.DeviceModel:
  return tmodel.DeviceModel(tmodel.load_npz(NPZ[digits]), dtype)


def to_np(x) -> np.ndarray:
  if isinstance(x, torch.Tensor):
    return x.detach().cpu().numpy()
  return np.asarray(x)


def assert_close(port, ref, rtol: float, atol: float, what: str = ""):
  np.testing.assert_allclose(to_np(port), to_np(ref), rtol=rtol, atol=atol,
                             err_msg=what)


def random_states(m, batch: int, seed: int):
  """Joint states over the whole range, a little past the limits at times
  (limit rows active), which drives fingertips into the floor and digits
  into each other (contacts active)."""
  rng = np.random.default_rng(seed)
  lo, hi = m.jnt_range[:, 0], m.jnt_range[:, 1]
  span = hi - lo
  qpos = rng.uniform(lo - 0.05 * span, hi + 0.05 * span, (batch, m.nq))
  qvel = rng.normal(0.0, 2.0, (batch, m.nv))
  act = rng.uniform(0.0, 1.0, (batch, m.na))
  ctrl = rng.uniform(-0.1, 1.1, (batch, m.nu))
  warm = rng.normal(0.0, 5.0, (batch, m.nv))
  return qpos, qvel, act, ctrl, warm


def jax_batch(m, qpos, qvel, act, ctrl, warm):
  """A batched JAX Data (float64) holding the given state."""
  B = qpos.shape[0]
  d0 = jdata.make_data(m, dtype=jnp.float64)
  d = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), d0)
  return d.replace(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel),
                   act=jnp.asarray(act), ctrl=jnp.asarray(ctrl),
                   qacc_warmstart=jnp.asarray(warm), overlay={})


def port_batch(jd) -> tdata.Data:
  """The port's Data holding exactly the JAX Data's values."""
  return tdata.data_from_numpy(jax.tree.map(np.asarray, jd))


@pytest.fixture
def jax_pose_env(monkeypatch):
  """The JAX ``PoseEnv`` class, imported without the env registry.

  ``myosuite_mjx_tpu.envs/__init__`` registers every task and needs the
  MyoSuite asset tree. A bare package module with the same ``__path__``
  lets ``envs.pose`` import; sys.modules is restored afterwards.
  """
  import myosuite_mjx_tpu
  names = ["myosuite_mjx_tpu.envs", "myosuite_mjx_tpu.envs.base",
           "myosuite_mjx_tpu.envs.pose"]
  added = [n for n in names if n not in sys.modules]
  for n in names:
    monkeypatch.delitem(sys.modules, n, raising=False)
  pkg = types.ModuleType("myosuite_mjx_tpu.envs")
  pkg.__path__ = [os.path.join(os.path.dirname(myosuite_mjx_tpu.__file__),
                               "envs")]
  monkeypatch.setitem(sys.modules, "myosuite_mjx_tpu.envs", pkg)
  monkeypatch.setattr(myosuite_mjx_tpu, "envs", pkg, raising=False)
  from myosuite_mjx_tpu.envs.pose import PoseEnv
  yield PoseEnv
  for n in added:
    sys.modules.pop(n, None)

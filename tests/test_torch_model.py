"""The port's model files: the checked-in fixtures, the npz round trip, the
enums, and the rule that the port imports no jax, flax or mujoco."""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from torch_parity import HAND_TARGET, NPZ, jax_model
from myosuite_mjx_tpu.engine import model as jmodel
from myosuite_mjx_tpu_torch.assets.fixtures import hand_fixture_xml
from myosuite_mjx_tpu_torch.engine import collision
from myosuite_mjx_tpu_torch.engine import model as tmodel
from myosuite_mjx_tpu_torch.tools.export_model import export_model

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


def _assert_models_equal(a: tmodel.Model, b: tmodel.Model):
  assert sorted(a.field_names()) == sorted(b.field_names())
  for name in a.field_names():
    x, y = getattr(a, name), getattr(b, name)
    if name == "opt":
      for f in dataclasses.fields(x):
        np.testing.assert_array_equal(getattr(x, f.name), getattr(y, f.name))
    elif isinstance(x, dict) and name != "names":
      assert sorted(x) == sorted(y), name
      for k in x:
        np.testing.assert_array_equal(x[k], y[k], err_msg=f"{name}[{k}]")
    elif isinstance(x, np.ndarray):
      assert x.dtype == y.dtype, name
      np.testing.assert_array_equal(x, y, err_msg=name)
    else:
      assert x == y, name


@pytest.mark.parametrize("digits", [2, 5])
def test_checked_in_npz_equals_fresh_export(digits):
  fresh = export_model(hand_fixture_xml(digits))
  with np.load(NPZ[digits]) as z:
    assert sorted(z.files) == sorted(fresh)
    for k in z.files:
      np.testing.assert_array_equal(z[k], fresh[k], err_msg=k)


@pytest.mark.parametrize("digits", [2, 5])
def test_from_reference_equals_load_npz(digits):
  ref = jax_model(digits)
  carried = tmodel.from_reference(ref)
  assert sorted(carried.field_names()) == sorted(
      f.name for f in dataclasses.fields(ref))
  _assert_models_equal(carried, tmodel.load_npz(NPZ[digits]))


def test_enums_and_disable_bits_match_the_reference():
  for name in ("JointType", "GeomType", "TrnType", "DynType", "GainType",
               "BiasType", "WrapType", "IntegratorType", "ConeType", "EqType",
               "SensorType"):
    ours = {k: int(v) for k, v in getattr(tmodel, name).__members__.items()}
    ref = {k: int(v) for k, v in getattr(jmodel, name).__members__.items()}
    assert ours == ref, name
  for name in dir(jmodel):
    if name.startswith("DSBL_"):
      assert getattr(tmodel, name) == getattr(jmodel, name), name


def test_load_npz_missing_path_raises():
  with pytest.raises(FileNotFoundError):
    tmodel.load_npz(os.path.join(REPO, "no_such_model.npz"))


def test_port_imports_no_jax_flax_or_mujoco():
  code = (
      "import pkgutil, sys, importlib\n"
      "import myosuite_mjx_tpu_torch as p\n"
      "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
      "for m in mods: importlib.import_module(m)\n"
      "bad = [k for k in ('jax', 'flax', 'mujoco') if k in sys.modules]\n"
      "assert len(mods) >= 15, mods\n"
      "assert not bad, bad\n")
  env = dict(os.environ, PYTHONPATH=REPO)
  out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
  assert out.returncode == 0, out.stderr


def test_hand23_has_myohand_width():
  m = tmodel.load_npz(NPZ[5])
  assert (m.nq, m.nv, m.nu, m.na) == (23, 23, 39, 39)
  names = sorted(m.names["joint"], key=m.names["joint"].get)
  assert names[:7] == ["pro_sup", "deviation", "flexion", "cmc_abduction",
                       "cmc_flexion", "mp_flexion", "ip_flexion"]
  for k in range(2, 6):
    i = 7 + 4 * (k - 2)
    assert names[i:i + 4] == [f"mcp{k}_flexion", f"mcp{k}_abduction",
                              f"pm{k}_flexion", f"md{k}_flexion"]
  tgt = np.asarray(HAND_TARGET)
  assert ((tgt >= m.jnt_range[:, 0]) & (tgt <= m.jnt_range[:, 1])).all()
  types = {(int(m.geom_type[p.g1]), int(m.geom_type[p.g2]))
           for p in collision.candidate_pairs(m)}
  assert types == {(0, 3), (3, 3)}           # plane-capsule, capsule-capsule
  # more slots than the top-k keeps: the cull is on the main path
  assert sum(collision._npoints(m, p) for p in collision.candidate_pairs(m)) > 24

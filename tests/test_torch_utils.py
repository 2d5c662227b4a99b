"""The small utilities (``utils/tensor_utils``, ``min_jerk``, ``curriculum``,
``xml_utils``): the port against the JAX modules on the same seeded
inputs, and the JAX package's own checks of them (``tests/test_utils.py``
and ``tests/test_xml_utils.py``) run on the port.

Tolerances: the min-jerk profile and the cosine are the same float64
arithmetic as JAX's (rtol 1e-12); the curriculum's float64 state equals
the reference law's (abs 1e-12); the path helpers and the MJCF surgery are
exact.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myosuite_mjx_tpu.utils import curriculum as jcur
from myosuite_mjx_tpu.utils import min_jerk as jmj
from myosuite_mjx_tpu.utils import tensor_utils as jtu
from myosuite_mjx_tpu.utils import xml_utils as jxml
from myosuite_mjx_tpu_torch.utils import curriculum, min_jerk, tensor_utils
from myosuite_mjx_tpu_torch.utils import xml_utils

F64 = dict(dtype=torch.float64, device="cpu")
TOL = dict(rtol=1e-12, atol=1e-14)


# ---------------------------------------------------------------------------
# tensor utils
# ---------------------------------------------------------------------------


def test_cosine_matches_jax_on_seeded_vectors():
  rng = np.random.default_rng(0)
  v1 = rng.normal(size=(4, 5, 3))
  v2 = rng.normal(size=(4, 5, 3))
  v1[0, 0] = 0.0                      # a zero norm gives 0
  v2[1, 2] = 0.0
  got = tensor_utils.calculate_cosine(torch.as_tensor(v1),
                                      torch.as_tensor(v2))
  np.testing.assert_allclose(got.numpy(),
                             np.asarray(jtu.calculate_cosine(v1, v2)), **TOL)
  assert float(got[0, 0]) == 0.0 and float(got[1, 2]) == 0.0


def test_cosine():
  v1 = torch.tensor([[1.0, 0, 0], [1, 1, 0]])
  v2 = torch.tensor([[0.0, 1, 0], [1, 1, 0]])
  np.testing.assert_allclose(tensor_utils.calculate_cosine(v1, v2).numpy(),
                             [0.0, 1.0], atol=1e-6)
  assert float(tensor_utils.calculate_cosine(torch.zeros(3),
                                             torch.ones(3))) == 0.0


def _paths(seed: int):
  rng = np.random.default_rng(seed)
  return [{"obs": rng.normal(size=(3, 2)),
           "info": {"r": rng.normal(size=3), "s": rng.integers(0, 5, 3)}}
          for _ in range(4)]


def _assert_trees_equal(a, b):
  if isinstance(a, dict):
    assert sorted(a) == sorted(b)
    for k in a:
      _assert_trees_equal(a[k], b[k])
  elif isinstance(a, list):
    assert len(a) == len(b)
    for x, y in zip(a, b):
      _assert_trees_equal(x, y)
  else:
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("fn, args", [
    ("stack_tensor_dict_list", ()), ("concat_tensor_dict_list", ()),
    ("pad_tensor_dict", (5,)), ("pad_tensor_dict", (6, "last")),
])
def test_tensor_dict_helpers_match_jax(fn, args):
  paths = _paths(1)
  arg = paths[0] if fn == "pad_tensor_dict" else paths
  _assert_trees_equal(getattr(tensor_utils, fn)(arg, *args),
                      getattr(jtu, fn)(arg, *args))


def test_split_truncate_flatten_and_pad_n_match_jax():
  stacked = jtu.stack_tensor_dict_list(_paths(2))
  _assert_trees_equal(tensor_utils.split_tensor_dict_list(stacked),
                      jtu.split_tensor_dict_list(stacked))
  _assert_trees_equal(tensor_utils.truncate_tensor_dict(stacked, 2),
                      jtu.truncate_tensor_dict(stacked, 2))
  rng = np.random.default_rng(3)
  parts = [rng.normal(size=(2, 2)), rng.normal(size=3), rng.normal(size=(1,))]
  flat = tensor_utils.flatten_tensors(parts)
  np.testing.assert_array_equal(flat, jtu.flatten_tensors(parts))
  _assert_trees_equal(
      tensor_utils.unflatten_tensors(flat, [(2, 2), (3,), (1,)]), parts)
  assert tensor_utils.flatten_tensors([]).shape == (0,)
  xs = [rng.normal(size=(k, 2)) for k in (1, 3, 2)]
  np.testing.assert_array_equal(tensor_utils.pad_tensor_n(xs, 4),
                                jtu.pad_tensor_n(xs, 4))


def test_tensor_dict_roundtrip():
  paths = [{"obs": np.ones((3, 2)), "info": {"r": np.arange(3.0)}}
           for _ in range(4)]
  stacked = tensor_utils.stack_tensor_dict_list(paths)
  assert stacked["obs"].shape == (4, 3, 2)
  assert stacked["info"]["r"].shape == (4, 3)
  split = tensor_utils.split_tensor_dict_list(stacked)
  assert len(split) == 4 and split[0]["info"]["r"].shape == (3,)
  cat = tensor_utils.concat_tensor_dict_list(paths)
  assert cat["obs"].shape == (12, 2)
  padded = tensor_utils.pad_tensor_dict(paths[0], 5)
  assert padded["obs"].shape == (5, 2)
  trunc = tensor_utils.truncate_tensor_dict(stacked, 2)
  assert trunc["obs"].shape == (2, 3, 2)
  flat = tensor_utils.flatten_tensors([np.ones((2, 2)), np.zeros(3)])
  back = tensor_utils.unflatten_tensors(flat, [(2, 2), (3,)])
  assert back[0].shape == (2, 2) and back[1].shape == (3,)


# ---------------------------------------------------------------------------
# min-jerk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n, T", [(50, 2.0), (7, 0.3)])
def test_min_jerk_spaces_match_jax(n, T):
  got = min_jerk.min_jerk_spaces(n, T, **F64)
  for g, r in zip(got, jmj.min_jerk_spaces(n, T)):
    np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


def test_min_jerk_matches_reference_formula():
  N, T = 50, 2.0
  p, pd, pdd = min_jerk.min_jerk_spaces(N, T, **F64)
  t = np.linspace(0, 1, N)
  np.testing.assert_allclose(p.numpy(), 10 * t**3 - 15 * t**4 + 6 * t**5,
                             atol=1e-12)
  np.testing.assert_allclose(pd.numpy(),
                             (30 * t**2 - 60 * t**3 + 30 * t**4) / T,
                             atol=1e-12)
  np.testing.assert_allclose(pdd.numpy(),
                             (60 * t - 180 * t**2 + 120 * t**3) / T**2,
                             atol=1e-12)
  with pytest.raises(ValueError):
    min_jerk.min_jerk_spaces(1, T, **F64)


def test_min_jerk_plan_matches_jax():
  rng = np.random.default_rng(4)
  start, goal = rng.normal(size=5), rng.normal(size=5)
  got = min_jerk.generate_joint_space_min_jerk(start, goal, 0.7, 0.01, **F64)
  ref = jmj.generate_joint_space_min_jerk(start, goal, 0.7, 0.01)
  assert sorted(got) == sorted(ref)
  for k in ref:
    np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), **TOL)
  wp, wref = min_jerk.as_waypoint_list(got), jmj.as_waypoint_list(ref)
  assert len(wp) == len(wref) == 70
  for a, b in zip(wp, wref):
    assert a["time_from_start"] == pytest.approx(b["time_from_start"],
                                                 abs=1e-15)
    np.testing.assert_allclose(a["position"].numpy(),
                               np.asarray(b["position"]), **TOL)


def test_min_jerk_trajectory_boundary_conditions():
  start = np.array([0.1, -0.5, 2.0])
  goal = np.array([1.0, 0.5, -1.0])
  traj = min_jerk.generate_joint_space_min_jerk(start, goal, 1.0, 0.01, **F64)
  assert traj["position"].shape == (100, 3)
  np.testing.assert_allclose(traj["position"][0].numpy(), start, atol=1e-12)
  np.testing.assert_allclose(traj["velocity"][0].numpy(), 0, atol=1e-10)
  np.testing.assert_allclose(traj["acceleration"][0].numpy(), 0, atol=1e-10)
  wp = min_jerk.as_waypoint_list(traj)
  assert len(wp) == 100 and wp[3]["time_from_start"] == pytest.approx(0.03)


# ---------------------------------------------------------------------------
# curriculum
# ---------------------------------------------------------------------------


def test_curriculum_matches_reference_semantics():
  cur = curriculum.Curriculum(threshold=90.0, rate=0.01, start=0.0,
                              end=2.0, filter_coef=0.95)
  # the reference law inline
  value, progress = 0.0, 0.0
  rng = np.random.default_rng(5)
  for _ in range(300):
    s = float(rng.uniform(80, 100))
    progress = progress * 0.95 + s * 0.05
    if value <= 1.0 and s >= 90.0 and progress >= 90.0:
      value += 0.01
    cur.update(s)
    assert cur.status() == pytest.approx(0.0 + value * 2.0, abs=1e-12)
  with pytest.raises(ValueError):
    curriculum.Curriculum(rate=0.0)


def test_curriculum_functional_matches_jax_on_device_state():
  """The functional form over a float64 tensor state against JAX's under
  x64, step by step on seeded successes (also as tensors: no host sync)."""
  rng = np.random.default_rng(6)
  succ = rng.uniform(85, 100, 200)
  st = curriculum.init(**F64)
  jst = jcur.init(jnp.float64)
  jupdate = jax.jit(jcur.update)
  for s in succ:
    st = curriculum.update(st, torch.tensor(s, **F64))
    jst = jupdate(jst, s)
    assert float(st.value) == pytest.approx(float(jst.value), abs=1e-12)
    assert float(st.progress) == pytest.approx(float(jst.progress),
                                               abs=1e-12)
  assert float(curriculum.status(st, 0.5, 2.0)) == pytest.approx(
      float(jcur.status(jst, 0.5, 2.0)), abs=1e-12)
  assert float(st.value) > 0.0


def test_curriculum_functional_saturates():
  st = curriculum.init(**F64)
  for _ in range(100):
    st = curriculum.update(st, 95.0)
  assert 0.0 < float(curriculum.status(st)) <= 1.01


# ---------------------------------------------------------------------------
# MJCF surgery
# ---------------------------------------------------------------------------

SCENE = """<mujoco model="scene">
  <!-- scene comment -->
  <worldbody>
    <body name="table" pos="0 0 0.5">
      <geom type="box" size="0.5 0.5 0.02"/>
    </body>
    <body name="mount" pos="1 0 0">
      <body name="arm" euler="0 0 1.57">
        <geom type="capsule" size="0.02 0.2"/>
        <body name="arm" pos="0 0 0.1"/>
      </body>
    </body>
  </worldbody>
</mujoco>"""

DONOR = """<mujoco model="donor">
  <asset><texture name="skin" type="2d"/></asset>
  <worldbody><body name="ball"><geom type="sphere" size="0.03"/></body>
  </worldbody>
</mujoco>"""


@pytest.mark.parametrize("call", [
    lambda x: x.to_xml_str(x.parse_mjcf(xml_str=SCENE)),
    lambda x: x.to_xml_str(x.parse_mjcf(xml_str=SCENE), pretty=True),
    lambda x: x.merge_mjcf(SCENE, DONOR),
    lambda x: x.to_xml_str(x.merge_mjcf(SCENE, DONOR,
                                        receiver_node="worldbody",
                                        destination="tree")),
    lambda x: x.reparent_body(xml_str=SCENE, new_parent="table", body="arm",
                              overrides={"pos": "0 0 0.1",
                                         "quat": "1 0 0 0"}),
    lambda x: x.reparent_body(xml_str=SCENE, new_parent="mount", body="arm"),
], ids=["parse", "pretty", "merge", "merge_node", "reparent", "same_parent"])
def test_xml_surgery_matches_jax(call):
  assert call(xml_utils) == call(jxml)


def test_parse_from_path_and_errors(tmp_path):
  path = tmp_path / "scene.xml"
  path.write_text(SCENE)
  assert xml_utils.to_xml_str(xml_utils.parse_mjcf(path=str(path))) == \
      jxml.to_xml_str(jxml.parse_mjcf(path=str(path)))
  assert "ball" in xml_utils.merge_mjcf(str(path), DONOR)
  with pytest.raises(ValueError):
    xml_utils.parse_mjcf()
  with pytest.raises(ValueError):
    xml_utils.merge_mjcf(SCENE, DONOR, receiver_node="nope")
  with pytest.raises(ValueError):
    xml_utils.reparent_body(xml_str=SCENE, new_parent="nope", body="arm")


def test_parse_preserves_comments():
  tree = xml_utils.parse_mjcf(xml_str=SCENE)
  assert "scene comment" in xml_utils.to_xml_str(tree)


def test_merge_appends_donor_sections():
  root = ET.fromstring(xml_utils.merge_mjcf(SCENE, DONOR))
  assert root.find("asset/texture") is not None
  assert len(root.findall(".//body[@name='ball']")) == 1


def test_merge_into_named_node():
  merged = xml_utils.merge_mjcf(SCENE, DONOR, receiver_node="worldbody",
                                destination="tree")
  wb = merged.getroot().find("worldbody")
  assert wb.find(".//body[@name='ball']") is not None
  assert wb.find("body[@name='table']") is not None


def test_reparent_moves_subtree_and_overrides():
  out = xml_utils.reparent_body(
      xml_str=SCENE, new_parent="table", body="arm",
      overrides={"pos": "0 0 0.1", "quat": "1 0 0 0"})
  root = ET.fromstring(out)
  arm = root.find(".//body[@name='table']/body[@name='arm']")
  assert arm is not None, "arm not moved under table"
  assert root.find(".//body[@name='mount']/body[@name='arm']") is None
  assert arm.get("pos") == "0 0 0.1"
  assert arm.get("euler") is None and arm.get("quat") == "1 0 0 0"


def test_reparent_missing_body_raises():
  with pytest.raises(ValueError):
    xml_utils.reparent_body(xml_str=SCENE, new_parent="table", body="nope")

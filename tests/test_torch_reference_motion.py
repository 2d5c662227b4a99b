"""Reference motions (``logger/reference_motion.py``): the port against the
JAX package, float64, on seeded clips.

- TRACK: lookups at every frame's time, at midpoints, at seeded times and
  past the end, with and without extrapolation; a clip with
  ``robot_vel``, one without (the time gradient), and one whose object
  horizon (4) is below the robot's (9), where the reference's gather
  clamps the object's frame index;
- RANDOM: the port returns the draws it is given (JAX's, rebuilt from its
  key), and its own draws stay in each part's range;
- FIXED: the one frame for every env;
- the init poses, the clip types and loading from .npz, .pkl and a dict.

Tolerance rtol 1e-12: the same float64 interpolation.
"""
from __future__ import annotations

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myosuite_mjx_tpu.logger import reference_motion as jref
from myosuite_mjx_tpu_torch.logger import reference_motion as pref

F64 = jnp.float64
TOL = dict(rtol=1e-12, atol=1e-14)


def _clip(horizon: int = 12, robot_vel: bool = True, object_horizon=None,
          seed: int = 0) -> dict:
  rng = np.random.default_rng(seed)
  t = np.cumsum(rng.uniform(0.02, 0.1, horizon))
  t = np.round(t - t[0], 4)
  clip = {"time": t, "robot": rng.normal(size=(horizon, 5))}
  if robot_vel:
    clip["robot_vel"] = rng.normal(size=(horizon, 5))
  oh = horizon if object_horizon is None else object_horizon
  q = rng.normal(size=(oh, 4))
  clip["object"] = np.concatenate(
      [rng.normal(size=(oh, 3)), q / np.linalg.norm(q, axis=1,
                                                     keepdims=True)], 1)
  return clip


def _times(clip: dict) -> np.ndarray:
  """Every frame's time, the midpoints, seeded times and times past the
  end (and one before the start)."""
  t = clip["time"]
  rng = np.random.default_rng(5)
  return np.concatenate([t, 0.5 * (t[1:] + t[:-1]),
                         rng.uniform(t[0], t[-1], 20),
                         t[-1] + np.array([1e-3, 0.05, 1.0]), [-0.01]])


def _pair(clip, extrapolation=True):
  return (jref.ReferenceMotion(clip, extrapolation, dtype=F64),
          pref.ReferenceMotion(clip, extrapolation, dtype=torch.float64))


def _compare(port: dict, ref: dict):
  assert sorted(port) == sorted(ref)
  for k, v in ref.items():
    if v is None:
      assert port[k] is None, k
    else:
      np.testing.assert_allclose(port[k].numpy(), np.asarray(v),
                                 err_msg=k, **TOL)


CASES = {
    "track": dict(),
    "track_no_robot_vel": dict(robot_vel=False),
    "track_short_object": dict(horizon=9, object_horizon=4),
}


@pytest.mark.parametrize("extrapolation", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_track_lookup_matches_jax(case, extrapolation):
  clip = _clip(**CASES[case])
  jm, pm = _pair(clip, extrapolation)
  assert pm.type.name == jm.type.name == "TRACK"
  assert (pm.horizon, pm.robot_horizon, pm.object_horizon) == (
      jm.horizon, jm.robot_horizon, jm.object_horizon)
  t = _times(clip)
  ref = jax.vmap(lambda x: jm.get_reference(x))(jnp.asarray(t))
  _compare(pm.get_reference(torch.as_tensor(t)), ref)
  if case == "track_no_robot_vel":
    np.testing.assert_allclose(
        pm.robot_vel, np.gradient(clip["robot"], clip["time"], axis=0),
        **TOL)
  if case == "track_short_object":
    # past the object's last row its frames clamp to that row
    late = pm.get_reference(torch.as_tensor([clip["time"][-1]]))
    np.testing.assert_allclose(late["object"][0].numpy(),
                               clip["object"][-1], **TOL)


def test_random_returns_the_episode_draw():
  clip = {"time": np.array((0.0, 4.0)), "robot": np.array(
      [np.zeros(5), np.ones(5)]), "robot_vel": np.zeros((2, 5)),
          "object": np.array([[-0.2, -0.2, 0.1, 1.0, 0.0, 0.0, -1.0],
                              [0.2, 0.2, 0.1, 1.0, 0.0, 0.0, 1.0]])}
  jm, pm = _pair(clip)
  assert pm.type.name == jm.type.name == "RANDOM"
  keys = jax.random.split(jax.random.PRNGKey(0), 6)
  t = np.linspace(0.0, 3.0, 6)
  ref = jax.vmap(jm.get_reference)(jnp.asarray(t), keys)
  draws = {k: torch.as_tensor(np.array(v)) for k, v in ref.items()}
  # the same draw whatever the time
  _compare(pm.get_reference(torch.as_tensor(t), draws), ref)
  _compare(pm.get_reference(torch.as_tensor(t[::-1].copy()), draws), ref)
  own = pm.draw(256, torch.Generator().manual_seed(0), "cpu")
  for k in ("robot", "robot_vel", "object"):
    lo = np.minimum(clip[k][0], clip[k][1])
    hi = np.maximum(clip[k][0], clip[k][1])
    x = own[k].numpy()
    assert x.shape == (256, clip[k].shape[1])
    assert (x >= lo).all() and (x <= hi).all(), k
  # the init defaults to the range's mean
  np.testing.assert_allclose(pm.get_init()[0], clip["robot"].mean(0), **TOL)
  np.testing.assert_allclose(pm.get_init()[1], clip["object"].mean(0),
                             **TOL)


def test_fixed_and_inits_match_jax():
  clip = {"time": np.array((0.0, 4.0)), "robot": np.arange(5.0)[None],
          "robot_vel": np.zeros((1, 5)),
          "object_init": np.array((-0.2, -0.2, 0.1, 1.0, 0.0, 0.0, 0.0)),
          "object": np.array([[0.2, 0.2, 0.1, 1.0, 0.0, 0.0, 0.1]])}
  jm, pm = _pair(clip)
  assert pm.type.name == jm.type.name == "FIXED"
  t = np.array([0.0, 1.0, 7.0])
  _compare(pm.get_reference(torch.as_tensor(t)),
           jax.vmap(jm.get_reference)(jnp.asarray(t)))
  for p, j in zip(pm.get_init(), jm.get_init()):
    np.testing.assert_allclose(p, np.asarray(j), **TOL)
  # TRACK inits: the first frame unless given
  clip = _clip()
  jm, pm = _pair(clip)
  for p, j in zip(pm.get_init(), jm.get_init()):
    np.testing.assert_allclose(p, np.asarray(j), **TOL)
  np.testing.assert_allclose(pm.get_init()[0], clip["robot"][0], **TOL)


def test_load_npz_pickle_and_dict(tmp_path):
  clip = _clip(robot_vel=False)
  npz = str(tmp_path / "clip.npz")
  np.savez(npz, **clip)
  pkl = str(tmp_path / "clip.pkl")
  with open(pkl, "wb") as f:
    pickle.dump(clip, f)
  t = torch.as_tensor(_times(clip))
  ref = pref.ReferenceMotion(clip, dtype=torch.float64).get_reference(t)
  for src in (npz, pkl):
    _compare(pref.ReferenceMotion(src, dtype=torch.float64).get_reference(t),
             {k: None if v is None else v.numpy() for k, v in ref.items()})
  with pytest.raises(TypeError):
    pref.ReferenceMotion(str(tmp_path / "clip.txt"))
  with pytest.raises(ValueError):
    pref.ReferenceMotion({"time": np.zeros(3)})


def test_float32_lookup_keeps_its_dtype():
  clip = _clip()
  pm = pref.ReferenceMotion(clip)
  out = pm.get_reference(torch.as_tensor(_times(clip), dtype=torch.float32))
  ref = pref.ReferenceMotion(clip, dtype=torch.float64).get_reference(
      torch.as_tensor(_times(clip)))
  for k in ("robot", "robot_vel", "object"):
    assert out[k].dtype == torch.float32
    np.testing.assert_allclose(out[k].numpy(), ref[k].numpy(), rtol=1e-5,
                               atol=1e-5)

"""The reflex walking controller (``agents/reflex.py``) and its CEM tuner
(``tools/tune_reflex.py``): the port against the JAX package on the
``legs80_reflex`` fixture (legs80 with MyoLeg's muscle names).

- ``reflex_update`` on seeded sensor dicts and phase states, float64:
  flags equal, stimulations within 1e-12 (the same arithmetic);
- the sensor dict and the ctrl of seeded leg states, float64: within
  rtol 1e-8, atol 1e-9 (a forward pass with contacts: Newton on stiff
  contact rows amplifies rounding, as ``TASK_TOL``);
- a float32 rollout of ``TICKS`` control ticks against JAX's float32
  rollout on the CPU: pelvis height and x within ``ROLLOUT_BOUND``,
  footsteps equal;
- the tuner's first generation against a JAX replay of the same
  candidates (the JAX tool's score on the JAX walker): fitness within
  ``ROLLOUT_BOUND`` and ticks alive equal.
"""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import bare_envs_package, fixture_xml
from myosuite_mjx_tpu.engine import data as jdata
from myosuite_mjx_tpu.engine import forward as jforward
from myosuite_mjx_tpu.engine import model as jmodel
from myosuite_mjx_tpu_torch.agents import reflex
from myosuite_mjx_tpu_torch.engine import data as tdata
from myosuite_mjx_tpu_torch.engine import forward as tforward
from myosuite_mjx_tpu_torch.tools import tune_reflex

with bare_envs_package():   # the JAX envs package registers asset ids
  from myosuite_mjx_tpu.agents import reflex as jreflex

P = 64
TICKS = 8
POP = 3
# float32 on the CPU in both packages over 8 ticks (40 substeps): 6e-8 in
# pelvis height on this fixture; the two engines round differently, and
# contacts amplify it
ROLLOUT_BOUND = 1e-5
STATE_TOL = dict(rtol=1e-8, atol=1e-9)
FLAGS = ("in_contact", "ph_st", "ph_st_csw", "ph_st_sw0", "ph_st_st",
         "ph_sw", "ph_sw_flex_k", "ph_sw_hold_k", "ph_sw_stop_l",
         "ph_sw_hold_l")


def _random_inputs(seed: int):
  """cp [P, 46] from params around 1 (BFSH_8_DG's spread wide, so the
  quirk shows), phase flags [P, 2] and a sensor dict [P, ...] spread over
  every threshold of the phase logic."""
  rng = np.random.default_rng(seed)
  params = rng.uniform(-0.5, 2.5, (P, reflex.N_PARAMS))
  cp = reflex.expand_params(params, torch.float64, "cpu").numpy()
  flags = {f: rng.random((P, 2)) < 0.5 for f in FLAGS}
  u = lambda lo, hi, shape=(P, 2): rng.uniform(lo, hi, shape)
  sens = {
      "theta": u(-0.4, 0.4), "d_pos": u(-1.0, 2.0), "dtheta": u(-2.0, 2.0),
      "load_ipsi": u(-0.1, 1.5), "alpha": u(0.8, 2.4),
      "dalpha": u(-3.0, 3.0), "alpha_f": u(1.2, 2.0),
      "phi_hip": u(2.0, 3.8), "phi_knee": u(1.6, 3.3),
      "phi_ankle": u(1.0, 2.2), "dphi_knee": u(-5.0, 5.0),
      "F_RF": u(-1.0, 0.2), "F_VAS": u(-1.0, 0.2), "F_GAS": u(-1.0, 0.2),
      "F_SOL": u(-1.0, 0.2)}
  sens["contact_ipsi"] = sens["load_ipsi"] > 0.1
  sens["contact_contra"] = sens["contact_ipsi"][:, ::-1].copy()
  sens["load_contra"] = sens["load_ipsi"][:, ::-1].copy()
  return params, cp, flags, sens


def test_expand_params_keeps_the_bfsh_quirk_and_matches_jax():
  params = np.random.default_rng(3).uniform(-2.0, 4.0, reflex.N_PARAMS)
  cp = reflex.expand_params(params, torch.float32, "cpu").numpy()
  np.testing.assert_array_equal(cp, np.asarray(jreflex.expand_params(params)))
  i = reflex.CP_IDX
  assert cp[i["BFSH_8_PG"]] == np.float32(params[i["BFSH_8_DG"]])
  assert reflex.N_PARAMS == len(reflex.CP_SPEC) == jreflex.N_PARAMS
  assert reflex.CP_SPEC == jreflex.CP_SPEC
  assert reflex.MUSCLE_GROUPS == jreflex.MUSCLE_GROUPS
  np.testing.assert_array_equal(reflex.baseline_params(),
                                jreflex.baseline_params())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reflex_update_matches_jax(seed):
  _, cp, flags, sens = _random_inputs(seed)
  jstate = jreflex.ReflexState(**{f: jnp.asarray(v) for f, v in
                                  flags.items()})
  jnew, jstim = jax.jit(jax.vmap(jreflex.reflex_update))(
      jnp.asarray(cp), jstate, {k: jnp.asarray(v) for k, v in sens.items()})
  state = reflex.ReflexState(**{f: torch.as_tensor(v)
                                for f, v in flags.items()})
  new, stim = reflex.reflex_update(
      torch.as_tensor(cp), state,
      {k: torch.as_tensor(v) for k, v in sens.items()})
  assert stim.shape == (P, 2, len(reflex.M_KEYS))
  for f in FLAGS:
    np.testing.assert_array_equal(getattr(new, f).numpy(),
                                  np.asarray(getattr(jnew, f)), err_msg=f)
  np.testing.assert_allclose(stim.numpy(), np.asarray(jstim), rtol=1e-12,
                             atol=1e-12)
  # the draws move every flag and reach both clips of the stimulation
  for f in FLAGS[1:]:
    assert (getattr(new, f).numpy() != flags[f]).any() or f == "ph_st_csw"
  assert (stim == 0.01).any() and (stim == 1.0).any()


def test_init_state_matches_jax():
  s = reflex.init_state(3, "cpu")
  js = jreflex.init_state()
  for f in FLAGS:
    np.testing.assert_array_equal(getattr(s, f).numpy(),
                                  np.broadcast_to(np.asarray(getattr(js, f)),
                                                  (3, 2)), err_msg=f)


@pytest.fixture(scope="module")
def walkers():
  """The port's float64 walker and the JAX walker carried to float64
  (the JAX constructor and reset pin float32)."""
  port = reflex.ReflexWalker(dtype=torch.float64)
  jw = jreflex.ReflexWalker(model_path=fixture_xml("legs80_reflex"))
  m64 = jmodel.load_model(fixture_xml("legs80_reflex"), dtype=np.float64)
  jw.model = m64
  jw.total_weight = float(np.sum(m64.body_mass) * 9.8)
  jw.fmax = {k: np.asarray(m64.actuator_biasprm[idx, 2], np.float64)
             for k, idx in jw.groups.items()}
  return port, jw


def _leg_states(port, seed: int, batch: int = 6):
  """The reset pose, then the fixture's keyframes with the joints moved
  and random velocities: feet on and off the floor."""
  rng = np.random.default_rng(seed)
  m = port.model
  d0, _ = port.reset(1, "cpu")
  keys = np.asarray(m.key_qpos)
  qpos = np.concatenate([d0.qpos.numpy(), keys[rng.integers(
      0, len(keys), batch - 1)]])
  qpos[1:, 7:] += rng.normal(0.0, 0.1, (batch - 1, m.nq - 7))
  qpos[1:, 2] -= rng.uniform(0.0, 0.03, batch - 1)
  qvel = np.concatenate([d0.qvel.numpy(),
                         rng.normal(0.0, 1.0, (batch - 1, m.nv))])
  return qpos, qvel


def test_sensor_dict_and_ctrl_match_jax(walkers):
  port, jw = walkers
  qpos, qvel = _leg_states(port, 0)
  B = len(qpos)
  dm = port.device_model("cpu")
  d = tdata.make_data(dm, B, torch.float64, "cpu")
  d = tforward.forward(dm, d.replace(qpos=torch.as_tensor(qpos),
                                     qvel=torch.as_tensor(qvel)))
  sens = port._sensor_data(d)

  m64 = jw.model
  d0 = jdata.make_data(m64, dtype=jnp.float64)

  def jax_side(q, v):
    dd = jforward.forward(m64, d0.replace(qpos=q, qvel=v))
    return jw._sensor_data(dd)

  jsens = jax.jit(jax.vmap(jax_side))(jnp.asarray(qpos), jnp.asarray(qvel))
  assert sorted(sens) == sorted(jsens)
  for k in sens:
    np.testing.assert_allclose(sens[k].numpy(), np.asarray(jsens[k]),
                               err_msg=k, **STATE_TOL)
  # contacts: some feet down and some up
  assert sens["contact_ipsi"].any() and not sens["contact_ipsi"].all()

  cp = reflex.expand_params(reflex.baseline_params(), torch.float64, "cpu")
  st = reflex.init_state(B, "cpu")
  _, stim = reflex.reflex_update(cp, st, sens)
  ctrl = port._stim_to_ctrl(stim)

  def jax_ctrl(s):
    _, jstim = jreflex.reflex_update(jnp.asarray(cp.numpy()),
                                     jreflex.init_state(), s)
    return jw._stim_to_ctrl(jstim)

  jctrl = jax.jit(jax.vmap(jax_ctrl))(jsens)
  np.testing.assert_allclose(ctrl.numpy(), np.asarray(jctrl), **STATE_TOL)
  # the five muscles in no group stay at 0
  assert int((ctrl == 0).all(0).sum()) == 10


@pytest.fixture(scope="module")
def jax_replay():
  """The JAX tool's score (``tools/tune_reflex.py``) on the JAX float32
  walker for the tuner's first generation (seed 0, sigma 0.15): fitness,
  ticks alive and, per tick, pelvis height, x and contact flags."""
  rng = np.random.default_rng(0)
  mu = np.ones(reflex.N_PARAMS)
  cand = np.clip(mu[None] + 0.15 * rng.standard_normal(
      (POP, reflex.N_PARAMS)), -2.0, 4.0)
  cand[0] = mu
  jw = jreflex.ReflexWalker(model_path=fixture_xml("legs80_reflex"))
  d0, s0 = jw.reset()
  b = jw.pelvis_bid
  up_axis = jnp.asarray(np.asarray(d0.xmat[b]).T @ np.array([0.0, 0.0, 1.0]),
                        jnp.float32)

  def score(params):
    cp = jreflex.expand_params(params)

    def tick(carry, _):
      d, s, alive, fall_x, t_alive = carry
      prev_x = d.xpos[b, 0]
      d, s = jw.step(d, s, cp)
      h = d.xpos[b, 2]
      up = d.xmat[b, 2, :] @ up_axis
      sane = (jnp.all(jnp.isfinite(d.qvel))
              & (jnp.max(jnp.abs(d.qvel)) < 100.0)
              & (jnp.abs(d.xpos[b, 0] - prev_x) < 0.1))
      alive = alive & (h > 0.65) & (h < 1.25) & (up > 0.5) & sane
      fall_x = jnp.where(alive, d.xpos[b, 0], fall_x)
      t_alive = t_alive + alive
      return (d, s, alive, fall_x, t_alive), (h, d.xpos[b, 0], s.in_contact)

    init = (d0, s0, jnp.asarray(True), jnp.asarray(0.0, jnp.float32),
            jnp.asarray(0, jnp.int32))
    (_, _, _, fall_x, t_alive), traj = jax.lax.scan(tick, init, (),
                                                   length=TICKS)
    return fall_x + 0.005 * t_alive, t_alive, traj

  fit, t_alive, (h, x, contact) = jax.jit(jax.vmap(score))(
      jnp.asarray(cand, jnp.float32))
  return dict(cand=cand, fit=np.asarray(fit), t_alive=np.asarray(t_alive),
              height=np.asarray(h), x=np.asarray(x),
              contact=np.asarray(contact))


def test_float32_rollout_matches_jax(jax_replay):
  walker = reflex.ReflexWalker()
  d, traj = walker.rollout(TICKS, batch=2, device="cpu")
  assert traj["height"].shape == (TICKS, 2)
  for k in ("height", "x"):
    ref = jax_replay[k][0]                   # candidate 0: ones(46)
    for p in range(2):
      np.testing.assert_allclose(traj[k][:, p].numpy(), ref, rtol=0,
                                 atol=ROLLOUT_BOUND, err_msg=k)
  c = jax_replay["contact"][0]
  assert traj["footsteps"].tolist() == [int((c[1:] & ~c[:-1]).sum())] * 2
  assert torch.isfinite(d.qpos).all()
  # the walker moves forward off its 1.5 m/s push
  assert (traj["x"][-1] > 0.05).all()


def test_tuner_first_generation_matches_jax_replay(jax_replay, tmp_path):
  walker = reflex.ReflexWalker()
  fit, t_alive = tune_reflex.score(walker, jax_replay["cand"], TICKS, "cpu")
  np.testing.assert_allclose(fit.double().numpy(), jax_replay["fit"],
                             rtol=0, atol=ROLLOUT_BOUND)
  np.testing.assert_array_equal(t_alive.numpy(), jax_replay["t_alive"])
  assert (t_alive > 0).all()

  out = str(tmp_path / "gains.npz")
  res = tune_reflex.main(["--generations", "2", "--pop", str(POP),
                          "--elite", "2", "--ticks", str(TICKS),
                          "--device", "cpu", "--out", out])
  hist = res["history"]
  # generation 0 scored the replayed candidates
  assert hist[0]["best"] == pytest.approx(float(jax_replay["fit"].max()),
                                          abs=ROLLOUT_BOUND)
  assert hist[1]["best_ever"] >= hist[0]["best_ever"]
  with np.load(out) as z:
    assert z["params"].shape == (reflex.N_PARAMS,)
    assert float(z["fitness"]) == res["best"]["fitness"]
  with open(out.replace(".npz", "_history.json")) as f:
    assert json.load(f) == hist

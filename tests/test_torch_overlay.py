"""Model overlay parity: per-env domain randomization against the JAX
package, float64, hand11.

``sample_overlay`` is held against JAX's from the same uniform draws
(rebuilt from JAX's key schedule, ``randomize.py:57-92``); ``forward`` and
``step`` with every overlay field on random contact-rich states are held
field by field against JAX's ``vmap``ped functions given the same overlay.
Also: a damping overlay on a model whose own damping is zero (JAX then
takes the implicit M + hD solve, ``forward.py:398``), a non-muscle model
(fixed and affine gains), and the autoreset that keeps the overlay of envs
that do not reset.

Tolerances: the overlay itself 1e-14 (one product per entry); single
stages before the Newton solve 1e-10 relative; after it 1e-8, and after 5
contact-rich steps 1e-6, as ``test_torch_engine.py`` states for the same
paths without an overlay.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (HAND_TARGET, NPZ, assert_close, bare_envs_package,
                          jax_batch, jax_model, port_batch, random_states,
                          to_np)
from myosuite_mjx_tpu.engine import forward as jforward
from myosuite_mjx_tpu.engine.model import load_model
from myosuite_mjx_tpu_torch.engine import forward
from myosuite_mjx_tpu_torch.engine.model import DeviceModel, from_reference
from myosuite_mjx_tpu_torch.envs import randomize
from myosuite_mjx_tpu_torch.envs.pose import PoseEnv

B = 8
SPEC = dict(body_mass=(0.5, 2.0), body_pos=(-0.01, 0.01),
            geom_size=(0.6, 1.4), geom_friction=(0.2, 3.0),
            dof_damping=(0.5, 4.0), actuator_gain=(0.5, 1.5))
OVERLAY_TOL = dict(rtol=1e-14, atol=1e-14)
STAGE = dict(rtol=1e-10, atol=1e-12)
SOLVED = dict(rtol=1e-8, atol=1e-8)
ROLLOUT = dict(rtol=1e-6, atol=1e-7)
# where each overlay field enters: the stage fields it changes
STAGE_FIELDS = ("xpos", "xipos", "geom_xpos", "subtree_com", "cinert", "qM",
                "actuator_force", "qfrc_actuator", "qfrc_passive",
                "qfrc_smooth", "qacc_smooth")
SOLVED_FIELDS = ("qfrc_constraint", "qacc", "contact_force")
OVERLAY_FIELDS = ("body_mass", "body_pos", "geom_size", "geom_friction",
                  "dof_damping", "actuator_gainprm", "actuator_biasprm")
POSITION_ACTUATORS = """<mujoco><option timestep="0.002"/><worldbody>
  <body><joint name="j0" type="hinge" axis="0 0 1" damping="0.1"/>
    <geom type="capsule" size=".02 .1" fromto="0 0 0 .2 0 0" mass="1"/>
    <body pos=".2 0 0"><joint name="j1" type="hinge" axis="0 1 0"/>
      <geom type="capsule" size=".02 .1" fromto="0 0 0 .2 0 0" mass=".5"/>
    </body></body></worldbody>
  <actuator><position joint="j0" kp="20" kv="2"/><motor joint="j1" gear="3"/>
  </actuator></mujoco>"""


def _jax_randomize():
  with bare_envs_package():
    from myosuite_mjx_tpu.envs import randomize as jrandomize
    return jrandomize


@functools.lru_cache(maxsize=None)
def _overlays(xml: str | None = None, seed: int = 0):
  """JAX's overlays for B envs, and the same draws as the port takes them
  (``keys = split(key, 6)``, one U(lo, hi) per field)."""
  jrand = _jax_randomize()
  jm = jax_model(2) if xml is None else load_model(xml)
  spec = jrand.RandomizeSpec(**SPEC)
  keys = jax.random.split(jax.random.PRNGKey(seed), B)
  jov = jax.vmap(lambda k: jrand.sample_overlay(k, jm, spec,
                                                jnp.float64))(keys)
  shapes = randomize.draw_shapes(from_reference(jm),
                                 randomize.RandomizeSpec(**SPEC), 1)
  order = ("body_mass", "body_pos", "geom_size", "geom_friction",
           "dof_damping", "actuator_gain")

  def one(k):
    ks = jax.random.split(k, 6)
    return {f: jax.random.uniform(ks[i], shapes[f][1:], jnp.float64,
                                  *SPEC[f]) for i, f in enumerate(order)}

  draws = jax.vmap(one)(keys)
  port = randomize.overlay_from_draws(
      from_reference(jm), {k: torch.as_tensor(np.array(v))
                           for k, v in draws.items()}, torch.float64)
  return jm, {k: np.asarray(v) for k, v in jov.items()}, port


def _forward_pair(jm, jov, seed: int = 0):
  jd = jax_batch(jm, *random_states(jm, B, seed)).replace(
      overlay={k: jnp.asarray(v) for k, v in jov.items()})
  pm = DeviceModel(from_reference(jm), torch.float64, "cpu")
  return jd, pm, port_batch(jd)


def test_sample_overlay_matches_jax_from_its_draws():
  _, jov, port = _overlays()
  assert sorted(port) == sorted(jov)
  for k in jov:
    assert_close(port[k], jov[k], what=k, **OVERLAY_TOL)
  assert (to_np(port["body_pos"])[:, 0] == _overlays()[0].body_pos[0]).all()


def test_sample_overlay_of_fixed_and_affine_actuators():
  """Non-muscle gain scales gainprm[:, 0]; an affine bias's -kp and -kv
  scale with it."""
  jm, jov, port = _overlays(POSITION_ACTUATORS)
  for k in ("actuator_gainprm", "actuator_biasprm"):
    assert_close(port[k], jov[k], what=k, **OVERLAY_TOL)
  s = to_np(port["actuator_gainprm"])[:, :, 0] / jm.actuator_gainprm[:, 0]
  assert_close(to_np(port["actuator_biasprm"])[:, 0, 1:3],
               s[:, :1] * jm.actuator_biasprm[0, 1:3], rtol=1e-14, atol=0)


def test_sample_overlay_draws_on_the_generator():
  m = from_reference(jax_model(2))
  spec = randomize.RandomizeSpec(**SPEC)
  a = randomize.sample_overlay(m, spec, B, torch.Generator().manual_seed(1),
                               "cpu", torch.float64)
  b = randomize.sample_overlay(m, spec, B, torch.Generator().manual_seed(1),
                               "cpu", torch.float32)
  for k in a:
    assert a[k].shape[0] == B and b[k].dtype == torch.float32
    assert_close(b[k], a[k], rtol=1e-6, atol=1e-7, what=k)
  assert not torch.equal(a["body_mass"][0], a["body_mass"][1])


def test_forward_with_every_overlay_field_matches_jax():
  jm, jov, _ = _overlays()
  jd, pm, pd = _forward_pair(jm, jov)
  jf = jax.jit(jax.vmap(lambda d: jforward.forward(jm, d)))(jd)
  pf = forward.forward(pm, pd)
  for f in STAGE_FIELDS:
    assert_close(getattr(pf, f), getattr(jf, f), what=f, **STAGE)
  for f in SOLVED_FIELDS:
    assert_close(getattr(pf, f), getattr(jf, f), what=f, **SOLVED)
  assert (to_np(pf.contact.dist) < 0).any()
  for f in ("dist", "friction", "pos"):
    assert_close(getattr(pf.contact, f), getattr(jf.contact, f),
                 what=f"contact.{f}", **SOLVED)


@pytest.mark.parametrize("field,reads", [
    ("body_mass", ("qM", "subtree_com")), ("body_pos", ("xpos", "qM")),
    ("geom_size", ("contact.dist",)), ("geom_friction", ("contact.friction",)),
    ("dof_damping", ("qfrc_passive",)),
    ("actuator_gainprm", ("actuator_force",)),
    ("actuator_biasprm", ("actuator_force",))], ids=lambda x: str(x))
def test_each_overlay_field_changes_what_reads_it(field, reads):
  """One field at a time against the nominal model: the stages that read
  it move, in every env (the muscles' passive force, which the bias
  scales, is zero below optimal length: some env)."""
  jm, jov, _ = _overlays()
  _, pm, pd = _forward_pair(jm, {field: jov[field]})
  pf = forward.forward(pm, pd)
  nominal = forward.forward(pm, pd.replace(overlay={}))
  for name in reads:
    a, b = pf, nominal
    for part in name.split("."):
      a, b = getattr(a, part), getattr(b, part)
    moved = (a - b).reshape(B, -1).abs().amax(-1) > 0
    assert (moved.any() if field == "actuator_biasprm" else moved.all()), name


def test_step_with_every_overlay_field_matches_jax():
  """5 contact-rich physics steps, every field overlaid."""
  jm, jov, _ = _overlays()
  jd, pm, pd = _forward_pair(jm, jov, seed=1)
  jstep = jax.jit(jax.vmap(functools.partial(jforward.step, jm)))
  for _ in range(5):
    jd = jstep(jd)
    pd = forward.step(pm, pd, full_data=True)
  assert sorted(pd.overlay) == sorted(jov)
  for f in ("qpos", "qvel", "act", "qacc", "qacc_warmstart"):
    assert_close(getattr(pd, f), getattr(jd, f), what=f, **ROLLOUT)


def test_damping_overlay_on_an_undamped_model_takes_the_implicit_solve():
  jm, jov, _ = _overlays()
  jm0 = dataclasses.replace(jm, dof_damping=np.zeros_like(jm.dof_damping))
  ov = {"dof_damping": jov["dof_damping"]}
  jd, pm0, pd = _forward_pair(jm0, ov, seed=2)
  jd = jax.jit(jax.vmap(functools.partial(jforward.step, jm0)))(jd)
  stepped = forward.step(pm0, pd, full_data=True)
  for f in ("qpos", "qvel", "qacc"):
    assert_close(getattr(stepped, f), getattr(jd, f), what=f, **SOLVED)
  # the explicit update (qvel += h qacc) would give another qvel
  fwd = forward.forward(pm0, pd)
  explicit = fwd.qvel + pm0.opt.timestep * fwd.qacc
  assert not torch.allclose(stepped.qvel, explicit)


def test_forward_on_a_non_muscle_model_with_gain_overlay():
  jm, jov, _ = _overlays(POSITION_ACTUATORS)
  rng = np.random.default_rng(3)
  ov = {k: jov[k] for k in ("actuator_gainprm", "actuator_biasprm")}
  jd = jax_batch(jm, rng.uniform(-1, 1, (B, jm.nq)),
                 rng.normal(0, 2, (B, jm.nv)), np.zeros((B, 0)),
                 rng.uniform(-1, 1, (B, jm.nu)), np.zeros((B, jm.nv)))
  jd = jd.replace(overlay={k: jnp.asarray(v) for k, v in ov.items()})
  pm = DeviceModel(from_reference(jm), torch.float64, "cpu")
  jf = jax.jit(jax.vmap(lambda d: jforward.forward(jm, d)))(jd)
  pf = forward.forward(pm, port_batch(jd))
  for f in ("actuator_force", "qfrc_actuator", "qacc"):
    assert_close(getattr(pf, f), getattr(jf, f), what=f, **STAGE)


class _OverlayPose(PoseEnv):
  def reset_overlay(self, batch, device, aux, generator):
    return randomize.sample_overlay(
        self.model, randomize.RandomizeSpec(**SPEC), batch, generator,
        device, self.dtype)


def test_autoreset_keeps_the_overlay_of_envs_that_do_not_reset():
  env = _OverlayPose(NPZ[2], dtype=torch.float64, frame_skip=2, horizon=3,
                     pose_thd=0.35, reset_type="init", target_type="fixed",
                     target_jnt_value=HAND_TARGET[:11])
  g = torch.Generator().manual_seed(0)
  st = env.reset(B, "cpu", g)
  old = {k: v.clone() for k, v in st.data.overlay.items()}
  # envs 0-3 reach the horizon at this step, 4-7 go on
  st = st.replace(steps=torch.tensor([2] * 4 + [0] * 4, dtype=torch.int32))
  nxt = env.autoreset_step(st, torch.full((B, env.action_dim), 0.5), g)
  assert to_np(nxt.info["truncated"]).tolist() == [True] * 4 + [False] * 4
  for k, v in nxt.data.overlay.items():
    assert torch.equal(v[4:], old[k][4:]), k
    assert not torch.equal(v[:4], old[k][:4]), k
  assert to_np(nxt.steps).tolist() == [0] * 4 + [1] * 4

"""chain72 (``assets/fixtures.chain_fixture_xml``), the scene with nv > 64:
the port's ``Physics`` against JAX ``forward.step``, float64 on the CPU.

JAX sends every solve outside the Pallas gate (n > 64, float64) to its
unrolled ``chol_factor`` / ``cho_solve``; the port's CPU path is the same
plain factor, and on the card the general kernel
(``csrc/spd_solve_general.cu``). Checked: the scene's width and its dense
72 x 72 mass matrix, Newton's H of the same size with active contacts, the
collision layout (the floor against each link, nothing else), and a
rollout of a few substeps at B = 2 within 1e-8 relative (the free-joint
rollout's bound: Newton on contact rows amplifies rounding).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (CHAIN_NPZ, assert_close, fixture_xml, jax_batch,
                          port_batch)
from myosuite_mjx_tpu.engine import forward as jforward
from myosuite_mjx_tpu.engine import model as jmodel
from myosuite_mjx_tpu_torch.assets.fixtures import CHAIN_LINKS
from myosuite_mjx_tpu_torch.engine import api, collision
from myosuite_mjx_tpu_torch.engine import model as tmodel
from myosuite_mjx_tpu_torch.ops import cuda_linalg, linalg

B = 2
STEPS = 4
ROLLOUT = dict(rtol=1e-8, atol=1e-10)


@pytest.fixture(scope="module")
def jm():
  return jmodel.load_model(fixture_xml("chain72"), dtype=np.float64)


@pytest.fixture(scope="module")
def rollout(jm):
  """(JAX Data, port Data, contacts seen) after STEPS substeps from qpos0
  with seeded joint velocities."""
  rng = np.random.default_rng(0)
  qpos = np.tile(jm.qpos0, (B, 1))
  qvel = rng.normal(scale=0.05, size=(B, jm.nv))
  z = np.zeros
  jd = jax_batch(jm, qpos, qvel, z((B, jm.na)), z((B, jm.nu)), z((B, jm.nv)))
  phys = api.Physics(tmodel.load_npz(CHAIN_NPZ), torch.float64, "cpu")
  pd = port_batch(jd)
  jstep = jax.jit(jax.vmap(functools.partial(jforward.step, jm)))
  active = []
  for _ in range(STEPS):
    jd = jstep(jd)
    pd = phys.step(pd)
    active.append(int(pd.ne_active.min()))
  return jd, pd, active


def test_chain72_width_and_layout():
  m = tmodel.load_npz(CHAIN_NPZ)
  assert m.nq == m.nv == CHAIN_LINKS == 72 and m.nu == m.na == 0
  pairs = collision.candidate_pairs(m)
  assert len(pairs) == 72
  floor = m.name2id("geom", "floor")
  assert all(floor in (p.g1, p.g2) for p in pairs)
  assert {(int(m.geom_type[p.g1]), int(m.geom_type[p.g2]))
          for p in pairs} == {(0, 3)}                  # plane-capsule


def test_rollout_matches_jax_step(rollout):
  jd, pd, active = rollout
  for f in ("qpos", "qvel", "qacc", "qfrc_constraint", "xpos", "qM"):
    assert_close(getattr(pd, f), getattr(jd, f), what=f, **ROLLOUT)
  np.testing.assert_array_equal(pd.ne_active.numpy(),
                                np.asarray(jd.ne_active))
  assert min(active) > 0, "the lying links lost their contacts"
  assert bool(torch.isfinite(pd.qpos).all())


def test_mass_matrix_is_dense_and_the_solves_are_n72(rollout):
  """M is dense (a serial chain), so every solve of the substep is 72 x 72:
  n > 64, the general kernel's range on the card."""
  _, pd, _ = rollout
  qM = pd.qM
  assert qM.shape == (B, 72, 72)
  assert bool((qM.abs() > 0).all())
  assert 72 > cuda_linalg.MAX_N
  # the factor the forward pass keeps is M's (plain path on the CPU)
  x, L = linalg.spd_solve(qM, pd.qfrc_smooth, factor=True)
  assert_close(L @ L.transpose(-1, -2), qM, rtol=1e-12, atol=1e-14)
  assert_close(pd.qLD, L, rtol=1e-12, atol=1e-14)
  assert_close(x, pd.qacc_smooth, rtol=1e-10, atol=1e-12)

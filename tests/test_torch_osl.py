"""The OSL impedance machine (``envs/osl.py``): the port against the JAX
package, float64, on 400 seeded sensor vectors and states, one JAX call
per sample. States must be equal; torques within rtol 1e-12 (the same
float64 arithmetic)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_parity import bare_envs_package
from myosuite_mjx_tpu_torch.envs import osl

with bare_envs_package():   # the JAX envs package registers asset ids
  from myosuite_mjx_tpu.envs import osl as josl

N = 400
BODY_WEIGHT = 63.65 * 9.81
TOL = dict(rtol=1e-12, atol=1e-12)


def _samples(seed: int):
  """States in 0..3 and sensors spread over every threshold: knee angle
  in [-1.5, 1.6] (30 and 50 degrees inside, and far enough below to
  reach the knee's peak torque), knee velocity in
  [-0.3, 0.3] (3 deg/s inside), ankle angle in [-0.5, 0.5] (6 degrees
  inside), ankle velocity in [-2, 2], load in [-0.1, 0.6] body weights
  (0.15, 0.25 and 0.4 inside)."""
  rng = np.random.default_rng(seed)
  state = rng.integers(0, 4, N).astype(np.int32)
  sens = np.stack([
      rng.uniform(-1.5, 1.6, N), rng.uniform(-0.3, 0.3, N),
      rng.uniform(-0.5, 0.5, N), rng.uniform(-2.0, 2.0, N),
      rng.uniform(-0.1, 0.6, N) * BODY_WEIGHT], 1)
  return state, sens


def _jax_steps(state, sens, p):
  import jax.numpy as jnp
  out_s, out_t = [], []
  for s, x in zip(state, sens):
    ns, tq = josl.step(jnp.asarray(s), jnp.asarray(x), p)
    out_s.append(int(ns))
    out_t.append(np.asarray(tq))
  return np.asarray(out_s), np.stack(out_t)


@pytest.mark.parametrize("gains", ["published", "overridden"])
def test_step_matches_jax_per_sample(gains):
  state, sens = _samples(0 if gains == "published" else 1)
  g = (osl.GAINS if gains == "published"
       else osl.GAINS * np.random.default_rng(2).uniform(0.5, 2.0, (4, 6)))
  jp = josl.OSLParams(body_weight=BODY_WEIGHT, gains=g)
  pp = osl.OSLParams(body_weight=BODY_WEIGHT, gains=g)
  ref_state, ref_torque = _jax_steps(state, sens, jp)
  new, tq = osl.step(torch.as_tensor(state), torch.as_tensor(sens), pp)
  assert new.dtype == torch.int32
  np.testing.assert_array_equal(new.numpy(), ref_state)
  np.testing.assert_allclose(tq.numpy(), ref_torque, **TOL)
  # the draws reach every transition and both torque clips
  moved = ref_state != state
  for s in range(4):
    assert moved[state == s].any() and (~moved[state == s]).any(), s
  peak = np.abs(ref_torque) >= osl.PEAK_TORQUE - 1e-9
  assert peak.any() and (~peak).any()


def test_tables_equal_the_reference():
  np.testing.assert_array_equal(osl.GAINS, josl.GAINS)
  np.testing.assert_array_equal(osl.PEAK_TORQUE, josl.PEAK_TORQUE)


def test_transition_and_torque_float32():
  """float32 tensors (the card's dtype) keep their dtype and agree with
  the float64 machine on states; torques within float32 rounding."""
  state, sens = _samples(3)
  p = osl.OSLParams(body_weight=BODY_WEIGHT)
  s64, t64 = osl.step(torch.as_tensor(state), torch.as_tensor(sens), p)
  s32, t32 = osl.step(torch.as_tensor(state), torch.as_tensor(sens).float(),
                      p)
  assert t32.dtype == torch.float32
  # a float32 sensor exactly at a threshold may round across it
  assert (s32 == s64).float().mean() >= 0.99
  same = (s32 == s64).numpy()
  np.testing.assert_allclose(t32.numpy()[same], t64.numpy()[same],
                             rtol=1e-5, atol=1e-4)

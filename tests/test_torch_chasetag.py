"""ChaseTagEnv (P1 and P2): the port against the JAX package, float64, on
the legs16 chase-tag scene (``legs_fixture_xml(8, chasetag=True)``).

The JAX class runs under ``jax.vmap`` with a registered id's kwargs. Its
draws are rebuilt from its key schedule and handed to the port through
``draw_opponent`` (from the aux key, split in 5: the task, the policy draw,
the spawn (an angle key, from which the reference draws both the angle and
the heading, and a radius key), the noise spectrum's two normal parts and
the chase speed) and ``draw_terrain`` (P2: ``ChaseTagField``'s draws from
the state key, rebuilt as in ``tests/test_torch_heightfields.py``).
frame_skip 2 and horizon 3 make autoreset fire inside the rollout; B = 4.

Tolerance: ``torch_parity.TASK_TOL`` (rtol 1e-8). P2's quadrant terrain is
built in float32 on both sides (the reference's generators default to
float32); its heights agree to the last float32 bit or so, which the
contacts carry into the physics: P2 is held at rtol 1e-5 (``P2_TOL``),
after its terrain is checked within 1e-6 of its largest height.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from torch_parity import (LEGS_NPZ, QueuedDraws, bare_envs_package,
                          fixture_xml, reset_split, task_kwargs,
                          task_rollout, to_np)
from myosuite_mjx_tpu_torch.envs.chasetag import ChaseTagEnv, colored_noise

B = 4
STEPS = 4
F64 = jnp.float64
P2_TOL = dict(rtol=1e-5, atol=1e-6)
NF = 1025


def _kwargs(part: str) -> dict:
  return task_kwargs(f"legs16ChaseTag{part}-v0", frame_skip=2, horizon=3)


@functools.lru_cache(maxsize=None)
def _jax_env(part: str):
  with bare_envs_package():
    from myosuite_mjx_tpu.envs.chasetag import ChaseTagEnv as J
    return J(fixture_xml("legs16_chasetag"), dtype=F64, **_kwargs(part))


class _Port(QueuedDraws, ChaseTagEnv):
  HOOKS = ("draw_opponent", "draw_terrain")

  def draw_opponent(self, batch, device, generator):
    return self.next_draw("draw_opponent", device)

  def draw_terrain(self, batch, device, generator):
    return self.next_draw("draw_terrain", device)

  def next_draw(self, hook, device):
    out = self.draws[hook].pop(0)
    return jax.tree.map(lambda x: torch.as_tensor(np.array(x),
                                                  device=device), out)


def _opponent(jenv, k):
  k_task, k_pol, k_spawn, k_noise, k_chase = jax.random.split(k, 5)
  task = (jax.random.randint(k_task, (), 0, 2)
          if jenv.task_choice == "random" else
          jnp.asarray(0 if jenv.task_choice == "CHASE" else 1))
  k_a, k_r = jax.random.split(k_spawn)
  k1, k2 = jax.random.split(k_noise)
  return dict(
      task=task, policy_u=jax.random.uniform(k_pol, ()),
      spawn_u=jax.random.uniform(k_a, (), F64),
      spawn_r=jax.random.uniform(k_r, (), F64, jenv.min_spawn_distance, 5.0),
      noise_re=jax.random.normal(k1, (2, NF)),
      noise_im=jax.random.normal(k2, (2, NF)),
      chase_vel=jax.random.uniform(k_chase, (), F64, *jenv.chase_vel_range))


def _field(jenv, k):
  nrow, ncol = jenv.field.shape
  qshape = (nrow // 2, ncol // 2)
  keys = jax.random.split(k, 8)
  quads = []
  for i in range(4):
    k_type, k_gen = keys[2 * i], keys[2 * i + 1]
    g1, g2, g3 = jax.random.split(k_gen, 3)
    quads.append(dict(
        pick=jax.random.randint(k_type, (), 0, 4),
        hilly=(jax.random.uniform(g1, (), jnp.float32, 0, 2 * jnp.pi),
               jax.random.uniform(g2, (), jnp.float32, 0, 2 * jnp.pi),
               jax.random.uniform(g3, (2,), jnp.float32, 0.5, 1.5)),
        rough=jax.random.uniform(k_gen, qshape, jnp.float32),
        relief=(jax.random.uniform(g1, (8,), jnp.float32, 0, qshape[0]),
                jax.random.uniform(g2, (8,), jnp.float32, 0, qshape[1]),
                jax.random.uniform(g3, (8,), jnp.float32, 1.0,
                                   float(min(qshape)) / 6))))
  out = jax.tree.map(lambda *xs: jnp.stack(xs), *quads)
  out["pick"] = out["pick"].astype(jnp.int64)
  return out


def _queue(penv, jenv):
  def queue(keys):
    k_aux, k_state = reset_split(keys)
    penv.draws["draw_opponent"].append(
        jax.vmap(lambda k: _opponent(jenv, k))(k_aux))
    if jenv.field is not None:
      penv.draws["draw_terrain"].append(
          jax.vmap(lambda k: _field(jenv, k))(k_state))
  return queue


def test_colored_noise_matches_jax():
  with bare_envs_package():
    from myosuite_mjx_tpu.envs import chasetag as jct
  keys = jax.random.split(jax.random.PRNGKey(4), 3)
  ref = jax.vmap(lambda k: jct._colored_noise(k, dtype=F64))(keys)

  def parts(k):
    k1, k2 = jax.random.split(k)
    return (jax.random.normal(k1, (2, NF)), jax.random.normal(k2, (2, NF)))

  re, im = jax.vmap(parts)(keys)
  out = colored_noise(torch.as_tensor(np.array(re)),
                      torch.as_tensor(np.array(im)))
  assert out.shape == (3, 2, 2048)
  torch_parity.assert_close(out, ref, rtol=1e-10, atol=1e-10)
  np.testing.assert_allclose(to_np(out).std(-1), 10.0, rtol=1e-12)


@pytest.mark.parametrize("part", ("P1", "P2"))
def test_autoreset_rollout_matches_jax(part, monkeypatch):
  jenv = _jax_env(part)
  penv = _Port(LEGS_NPZ["legs16_chasetag"], dtype=torch.float64,
               **_kwargs(part))
  assert penv.RESET_CONSTRAINT is True
  if part == "P2":
    monkeypatch.setattr(torch_parity, "TASK_TOL", P2_TOL)
  jst, pst, ends = task_rollout(jenv, penv, _queue(penv, jenv), B, STEPS)
  assert ends > 0
  d = pst.data
  # the opponent's pose is on the mocap body, and the feet touch
  np.testing.assert_allclose(to_np(d.mocap_pos), np.asarray(
      jst.data.mocap_pos), rtol=1e-8, atol=1e-9)
  assert (to_np(pst.obs) != 0).any() and (to_np(d.contact.dist) < 0).any()
  if part == "P2":
    h, ref = to_np(d.overlay["hfield_data"]), np.asarray(
        jst.data.overlay["hfield_data"])
    np.testing.assert_allclose(h, ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    assert np.ptp(h) > 0
  else:
    assert not d.overlay

"""TerrainWalkEnv (rough, hilly and stairs): the port against the JAX
package, float64, on legs16, with JAX's draws for the random reset and the
rough terrain (see ``tests/test_torch_walk.py`` for the key schedule, the
hooks and the tolerance). The registered hilly and stair walks are the
"fixed" variants; the random scale of the others goes through the same
``draw_terrain`` hook and is checked here against the reference's recipe.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_walk import TERRAIN_CASES, check_rollout
from torch_parity import LEGS_NPZ, bare_envs_package, fixture_xml, to_np
from myosuite_mjx_tpu_torch.envs.walk import TerrainWalkEnv


@pytest.mark.parametrize("case", TERRAIN_CASES)
def test_autoreset_rollout_matches_jax(case):
  penv, pst = check_rollout(case)
  # the terrain stays where the scene puts it
  tid = penv.model.name2id("geom", "terrain")
  assert penv.model.geom_pos[tid][2] == 0.0


@pytest.mark.parametrize("terrain", ("hilly", "stairs"))
def test_random_scale_matches_the_reference_recipe(terrain):
  """The random variants' overlay: the reference's recipe (built by the JAX
  class's ``reset_overlay`` with the key's draw) for a given scale."""
  import jax
  import jax.numpy as jnp
  with bare_envs_package():
    from myosuite_mjx_tpu.envs.walk import TerrainWalkEnv as J
    jenv = J(fixture_xml("legs16"), dtype=jnp.float64, terrain=terrain)
  key = jax.random.PRNGKey(3)
  ref = np.asarray(jenv.reset_overlay(key, {})["hfield_data"])
  lo, hi = (0.53, 0.73) if terrain == "hilly" else (1.5, 3.5)
  scale = np.asarray(jax.random.uniform(key, (), jnp.float64, lo, hi))

  class Port(TerrainWalkEnv):
    def draw_terrain(self, batch, device, generator):
      return torch.full((batch,), float(scale), dtype=torch.float64)

  penv = Port(LEGS_NPZ["legs16"], dtype=torch.float64, terrain=terrain)
  out = to_np(penv.reset_overlay(2, "cpu", {}, None)["hfield_data"])
  np.testing.assert_allclose(out, np.broadcast_to(ref, out.shape),
                             rtol=1e-12, atol=1e-14)
  g = torch.Generator().manual_seed(0)
  drawn = TerrainWalkEnv(LEGS_NPZ["legs16"], dtype=torch.float64,
                         terrain=terrain).draw_terrain(64, "cpu", g)
  assert drawn.shape == (64,) and (drawn >= lo).all() and (drawn <= hi).all()

"""Visual observations (``envs/visual.py``): the key grammar and the
encoders against the JAX package's, and the ``flax_cnn`` encoder against
the Flax net with the same weights in float64 (within 1e-10: the same
arithmetic, summed in another order), at frame sizes whose SAME padding
is asymmetric (even sides) and symmetric (odd)."""
from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import as_float64, bare_envs_package
from myosuite_mjx_tpu_torch.envs import visual

with bare_envs_package():   # the JAX envs package registers asset ids
  from myosuite_mjx_tpu.envs import visual as jvisual


@pytest.fixture
def flax_cnn(monkeypatch):
  """The JAX ``FlaxCNNEncoder`` class. Its Flax net is a dataclass made
  when the encoder is built, which looks its module up in sys.modules."""
  monkeypatch.setitem(sys.modules, jvisual.__name__, jvisual)
  return jvisual.FlaxCNNEncoder


@pytest.mark.parametrize("key", [
    "rgb:hand_side_inter:84x84:1d", "rgb:cam:with:colons:32x48:flax_cnn",
    "rgb::8x8:2d", "rgb:0:120x160:r3m"])
def test_parse_visual_key_matches_jax(key):
  assert visual.parse_visual_key(key) == jvisual.parse_visual_key(key)


def test_parse_visual_key_refuses_other_keys():
  for mod in (visual, jvisual):
    with pytest.raises(ValueError):
      mod.parse_visual_key("depth:cam:8x8:1d")


def test_array_encoders_and_registry(monkeypatch):
  monkeypatch.setattr(visual, "_ENCODERS", dict(visual._ENCODERS))
  frames = np.random.default_rng(0).integers(0, 256, (5, 8, 6, 3),
                                             dtype=np.uint8)
  for name in ("1d", "2d"):
    np.testing.assert_array_equal(
        visual.encoder(name, 8, 6)(frames), jvisual._ENCODERS[name](frames))
    torch_out = visual.encoder(name, 8, 6)(torch.as_tensor(frames))
    np.testing.assert_array_equal(torch_out.numpy(),
                                  jvisual._ENCODERS[name](frames))
  assert visual.encoder("1d", 8, 6)(frames).shape == (5, 144)
  visual.register_encoder("mean", lambda f: f.mean(axis=(1, 2)))
  assert visual.encoder("mean", 8, 6)(frames).shape == (5, 3)
  with pytest.raises(ValueError, match="unknown encoder"):
    visual.encoder("vc1", 8, 6)


@pytest.mark.parametrize("hw", [(84, 84), (21, 30)])
def test_cnn_shapes(hw):
  enc = visual.encoder("flax_cnn", *hw, device="cpu")
  assert isinstance(enc, visual.FlaxCNNEncoder)
  frames = torch.randint(0, 256, (4, *hw, 3), dtype=torch.uint8)
  out = enc(frames)
  assert out.shape == (4, 64) and out.dtype == torch.float32
  assert torch.isfinite(out).all()
  # flax's lecun_normal: the dense layer's std is sqrt(1 / fan_in)
  w = enc.dense.weight.detach()
  fan_in = w.shape[1]
  assert abs(float(w.std()) * fan_in ** 0.5 - 1.0) < 0.1


@pytest.mark.parametrize("hw", [(84, 84), (21, 30)])
def test_cnn_matches_flax_with_the_same_weights(hw, flax_cnn):
  rng = np.random.default_rng(1)
  frames = rng.integers(0, 256, (6, *hw, 3), dtype=np.uint8)
  jenc = flax_cnn(out_dim=64, seed=0)
  params = as_float64(jenc.net.init(jax.random.PRNGKey(0),
                                    jnp.asarray(frames)))
  # spread the biases, which flax initialises at zero
  params = jax.tree.map(
      lambda x: x + 0.05 * jnp.asarray(rng.standard_normal(x.shape))
      if x.ndim == 1 else x, params)
  ref = np.asarray(jenc.net.apply(params, jnp.asarray(frames)))
  assert ref.dtype == np.float64
  enc = visual.encoder_from_flax(jax.tree.map(np.asarray, params), *hw,
                                 dtype=torch.float64, device="cpu")
  out = enc(torch.as_tensor(frames))
  np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-10,
                             atol=1e-10)
  # the float32 module agrees to float32 rounding
  enc32 = visual.encoder_from_flax(jax.tree.map(np.asarray, params), *hw,
                                   device="cpu")
  np.testing.assert_allclose(enc32(torch.as_tensor(frames)).detach().numpy(),
                             ref, rtol=1e-4, atol=1e-4)


def test_encoder_from_flax_refuses_another_frame_size(flax_cnn):
  frames = jnp.zeros((1, 84, 84, 3), jnp.uint8)
  jenc = flax_cnn(out_dim=8)
  params = jax.tree.map(np.asarray, jenc.net.init(jax.random.PRNGKey(0),
                                                  frames))
  with pytest.raises(ValueError, match="flattens"):
    visual.encoder_from_flax(params, 64, 64, device="cpu")

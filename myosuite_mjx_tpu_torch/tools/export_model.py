"""Compile an MJCF scene on the host and write the port's ``.npz`` model.

The GPU machine has no ``mujoco``, so scenes are compiled here with the JAX
package's host compiler (``myosuite_mjx_tpu.engine.model.load_model``: numpy
and mujoco, no jax) and shipped as arrays. ``engine.model.load_npz`` reads
the file back.

Run from the repo root to refresh the checked-in fixture models:

    python -m myosuite_mjx_tpu_torch.tools.export_model
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from myosuite_mjx_tpu_torch.assets.fixtures import hand_fixture_xml
from myosuite_mjx_tpu_torch.engine import model as model_mod

ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")
FIXTURES = {"hand11": 2, "hand23": 5}


def export_model(xml: str) -> dict[str, np.ndarray]:
  """Compile MJCF text (or a path) and return the npz payload."""
  from myosuite_mjx_tpu.engine.model import load_model
  return model_mod.to_npz_payload(
      model_mod.from_reference(load_model(xml, dtype=np.float64)))


def write_npz(path: str, xml: str) -> None:
  np.savez_compressed(path, **export_model(xml))


def main(argv=None) -> None:
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--out-dir", default=ASSET_DIR)
  args = ap.parse_args(argv)
  for name, digits in FIXTURES.items():
    path = os.path.join(args.out_dir, f"{name}.npz")
    write_npz(path, hand_fixture_xml(digits))
    print(path)


if __name__ == "__main__":
  main()

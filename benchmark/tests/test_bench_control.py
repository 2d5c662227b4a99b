"""The control comes out not correct: the reference put in the program's
place in the nearest precision below the configuration's (float32 with
TF32 on, where the configuration states float32 with TF32 off), at a size
a test run holds. Needs a CUDA card (TF32 exists only there):

    python -m pytest -n 0 -m gpu benchmark/tests/test_bench_control.py
"""
import pytest
import torch

from benchmark import run as bench_run
from benchmark.harness import lookup

SIZE = dict(batch=512, action_pool=8, check_block=512)


@pytest.mark.gpu
@pytest.mark.parametrize("name", [w["name"] for w in
                                  lookup.bench_spec()["workloads"]])
@pytest.mark.parametrize("seed", [31, 32, 33])
def test_control_is_not_correct(name, seed):
  if not torch.cuda.is_available():
    pytest.skip("the control's TF32 exists only on a CUDA card")
  cell = lookup.cell(name)
  cell.traffic.update(SIZE)
  out = bench_run.measure(cell, seed, 1.0, False, control=True)
  assert not out["correct"], out["numbers"]

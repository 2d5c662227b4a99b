"""With the timed path broken underneath, a run's ``correct`` comes out
false: each fault that a cell can have, planted in the program, on the CPU
at a tiny size (the harness's look for a card is skipped; the rest of a
run is driven)."""
import pytest

from benchmark import run as bench_run
from benchmark.harness import faults, lookup
from benchmark.tests.test_bench_reference import _tiny

CASES = [(w["name"], f) for w in lookup.bench_spec()["workloads"]
         for f in faults.FAULTS]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_fails_the_check(name, fault, monkeypatch):
  from myosuite_mjx_tpu_torch.envs import base
  monkeypatch.setattr(base.BatchedEnv, "step", base.BatchedEnv.step)
  faults.plant(fault)
  out = bench_run.measure(_tiny(lookup.cell(name)), 12, 0.2, False,
                          device="cpu")
  assert not out["correct"], out["numbers"]

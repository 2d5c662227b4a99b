"""The plain reference against the port's CPU path at a tiny batch: in
float64 the frozen copy takes the same steps as the port, and the harness's
whole check (the port in float32 against the reference in float64) passes
under each cell's limits."""
import pytest
import torch

from benchmark import run as bench_run
from benchmark.harness import lookup
from benchmark.reference import step as ref_step

CELLS = [w["name"] for w in lookup.bench_spec()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_reference_step_is_the_ports_in_float64(name):
  from myosuite_mjx_tpu_torch import envs
  cell = lookup.cell(name)
  tr, scene = cell.traffic, lookup.scene_path(cell.config)
  port = envs.make(tr["task"], model_path=scene, dtype=torch.float64)
  ref = ref_step.make_env(tr["reference"], scene, torch.float64)
  B = 4
  gens = [torch.Generator().manual_seed(7) for _ in range(2)]
  sp, sr = port.reset(B, "cpu", gens[0]), ref.reset(B, "cpu", gens[1])
  torch.testing.assert_close(sp.obs, sr.obs, rtol=0, atol=0)
  a = torch.Generator().manual_seed(8)
  for _ in range(2):
    act = torch.rand((B, port.action_dim), generator=a,
                     dtype=torch.float64) * 2 - 1
    sp = port.autoreset_step(sp.replace(steps=sp.steps + 60), act, gens[0])
    sr = ref.autoreset_step(sr.replace(steps=sr.steps + 60), act, gens[1])
    for x, y in ((sp.data.qpos, sr.data.qpos), (sp.data.qvel, sr.data.qvel),
                 (sp.obs, sr.obs), (sp.reward, sr.reward)):
      torch.testing.assert_close(x, y, rtol=1e-12, atol=1e-12)
    assert torch.equal(sp.steps, sr.steps) and torch.equal(sp.done, sr.done)


def _tiny(cell):
  cell.traffic.update(batch=8, action_pool=4, warmup_steps=1, check_steps=2,
                      check_block=4)
  return cell


@pytest.mark.parametrize("name", CELLS)
def test_the_port_passes_the_check_on_the_cpu(name):
  out = bench_run.measure(_tiny(lookup.cell(name)), 11, 0.2, False,
                          device="cpu")
  assert out["correct"], out["numbers"]
  assert out["attempted"] >= 1 and out["failed"] == 0

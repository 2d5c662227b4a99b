"""Data-parallel training (``parallel/mesh.py``) on ``gloo`` processes on
the CPU: one sharded PPO and NPG step at world sizes 1, 2 and 4 against
the single-process step from the same seed, float64, every parameter and
metric within 1e-9 relative (the residual is the order of the
reductions across processes; the JAX package's own check is a cosine
above 0.9). PPO runs 2 epochs of 2 minibatches, so the minibatch
advantage statistics and the averaged gradients cross processes four
times. Then the command line's ``--mesh data`` in one process and under
``torchrun``, and the configurations that must raise."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from myosuite_mjx_tpu_torch.parallel import mesh as pmesh
from myosuite_mjx_tpu_torch.tools import scaling_efficiency as scaling
from myosuite_mjx_tpu_torch.train import cli, npg, ppo

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
BOUND = 1e-9
CONFIGS = {
    "ppo": dict(num_envs=8, unroll_length=4, num_minibatches=2,
                update_epochs=2, data_groups=4),
    "npg": dict(num_envs=8, vf_batch_size=8),
}
SPECS = scaling.specs_for("hand11PoseFixed-v0", ("ppo", "npg"),
                          configs=CONFIGS, device="cpu")


@pytest.fixture(scope="module")
def references():
  return [scaling.step_once(scaling.make_learner(s)) for s in SPECS]


@pytest.fixture(scope="module", params=[1, 2, 4])
def sharded(request):
  return request.param, scaling.run_sharded(request.param, SPECS)


@pytest.mark.parametrize("algo", ["ppo", "npg"])
def test_sharded_step_equals_single_process(sharded, references, algo):
  world, ranks = sharded
  i = [s["algo"] for s in SPECS].index(algo)
  ts, metrics = references[i]
  assert len(ranks) == world
  for rank in ranks:
    errs = scaling.relative_errors(ts, metrics, rank[i]["params"],
                                   rank[i]["metrics"])
    assert max(errs.values()) <= BOUND, errs
  # the replicas hold one learner
  for rank in ranks[1:]:
    assert torch.equal(rank[i]["params"], ranks[0][i]["params"])


def test_one_process_mesh_is_the_plain_step():
  learner = scaling.make_learner(SPECS[0])
  mesh = pmesh.data_mesh()
  assert mesh == pmesh.DataMesh(None, 1, 0)
  sh = pmesh.ShardedPPO(learner, mesh)
  ts, m = scaling.step_once(sh)
  ref, ref_m = scaling.step_once(scaling.make_learner(SPECS[0]))
  errs = scaling.relative_errors(ref, ref_m, scaling.flat_params(ts), m)
  assert max(errs.values()) <= BOUND, errs


@pytest.mark.parametrize("algo", ["ppo", "npg"])
def test_one_process_group_is_the_plain_step_exactly(algo, monkeypatch):
  """A gloo group of one process runs every collective, and each process
  reduces its share with the plain learner's own calls first: the step
  is the plain step to the last bit."""
  for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
    monkeypatch.delenv(k, raising=False)
  spec = SPECS[[s["algo"] for s in SPECS].index(algo)]
  spec = dict(spec, dtype="float32")
  assert pmesh.init_distributed(scaling.free_address(), 1, 0,
                                device="cpu") is False
  try:
    mesh = pmesh.data_mesh()
    assert mesh.group is not None and mesh.world == 1
    sharded = (pmesh.ShardedPPO if algo == "ppo" else pmesh.ShardedNPG)(
        scaling.make_learner(spec), mesh)
    ts, m = scaling.step_once(sharded)
  finally:
    torch.distributed.destroy_process_group()
  ref, ref_m = scaling.step_once(scaling.make_learner(spec))
  assert torch.equal(scaling.flat_params(ts), scaling.flat_params(ref))
  assert m == ref_m
  assert int(ts.steps) == int(ref.steps)


def test_shard_env_batch_takes_this_rank_rows():
  mesh = pmesh.DataMesh(None, 4, 2)
  tree = {"x": torch.arange(8.0), "s": torch.tensor(3.0), "n": [1],
          "d": ppo.RunningNorm(torch.arange(8.0), torch.ones(8, 2),
                               torch.tensor(2.0))}
  out = pmesh.shard_env_batch(mesh, tree)
  assert out["x"].tolist() == [4.0, 5.0]
  assert out["s"].item() == 3.0 and out["n"] == [1]
  assert out["d"].mean.tolist() == [4.0, 5.0]
  assert out["d"].var.shape == (2, 2) and out["d"].count.item() == 2.0


@pytest.mark.parametrize("env", [
    {"WORLD_SIZE": "2"},                                   # no address
    {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1"},      # no world size
    {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1", "WORLD_SIZE": "2"},
    {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1", "WORLD_SIZE": "2",
     "RANK": "2"},                                         # rank past world
])
def test_a_bad_configuration_raises(monkeypatch, env):
  for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
    monkeypatch.delenv(k, raising=False)
  for k, v in env.items():
    monkeypatch.setenv(k, v)
  with pytest.raises(ValueError):
    pmesh.init_distributed(device="cpu")
  assert not torch.distributed.is_initialized()


def test_no_configuration_is_one_process(monkeypatch):
  for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
    monkeypatch.delenv(k, raising=False)
  assert pmesh.init_distributed(device="cpu") is False
  with pytest.raises(ValueError, match="no address"):
    pmesh.init_distributed(world_size=2, rank=0, device="cpu")


def test_sharded_learners_check_their_split():
  learner = scaling.make_learner(SPECS[0])
  with pytest.raises(ValueError, match="num_envs"):
    pmesh.ShardedPPO(learner, pmesh.DataMesh(None, 3, 0))
  with pytest.raises(ValueError, match="data_groups"):
    pmesh.ShardedPPO(learner, pmesh.DataMesh(None, 8, 0))
  with pytest.raises(ValueError, match="num_envs"):
    pmesh.ShardedNPG(scaling.make_learner(SPECS[1]),
                     pmesh.DataMesh(None, 3, 0))


CLI_ARGS = ["--env", "hand11PoseFixed-v0", "--num-envs", "4",
            "--device", "cpu", "--mesh", "data", "--log-every", "1"]


@pytest.mark.parametrize("algo", ["ppo", "npg"])
def test_cli_mesh_data_in_one_process(algo, tmp_path, monkeypatch):
  for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
    monkeypatch.delenv(k, raising=False)
  steps = 4 * (50 if algo == "ppo" else 100)
  out = tmp_path / "m.json"
  ts = cli.main(CLI_ARGS + ["--algo", algo, "--total-steps", str(steps),
                            "--metrics-out", str(out)])
  assert int(ts.steps) == steps
  hist = json.loads(out.read_text())["history"]
  assert len(hist) == 1 and hist[0]["env_steps"] == steps
  assert isinstance(ts, ppo.TrainState if algo == "ppo" else npg.NPGState)


def test_cli_mesh_data_under_torchrun(tmp_path):
  """Two gloo processes: rank 0 prints the records and writes the
  metrics; each process checkpoints its own envs."""
  env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
  for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
    env.pop(k, None)
  out = subprocess.run(
      [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=2",
       "--master_port", scaling.free_address().rsplit(":", 1)[1],
       "-m", "myosuite_mjx_tpu_torch.train.cli", *CLI_ARGS,
       "--algo", "npg", "--total-steps", "800",
       "--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every", "2",
       "--metrics-out", str(tmp_path / "m.json")],
      cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
  assert out.returncode == 0, out.stderr[-3000:]
  records = [json.loads(line) for line in out.stdout.splitlines()
             if line.startswith("{")]
  assert [r["iter"] for r in records] == [1, 2]
  hist = json.loads((tmp_path / "m.json").read_text())["history"]
  assert [r["env_steps"] for r in hist] == [400, 800]
  assert sorted(os.listdir(tmp_path / "ck")) == [
      "iter_0000002", "iter_0000002.rank1"]

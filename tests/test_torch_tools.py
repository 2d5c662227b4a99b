"""The repository's tools ported to the PyTorch package, on fixture ids
and the CPU: ``train_zoo_baseline`` writes a snapshot that the zoo loads
(and that acts as the trained policy), ``convergence_study`` prints the
Newton iterations' percentiles, and ``scaling_efficiency`` checks and
times the data-parallel step at two gloo processes."""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from myosuite_mjx_tpu_torch.tools import (convergence_study,
                                          scaling_efficiency,
                                          train_zoo_baseline)
from myosuite_mjx_tpu_torch.train import zoo


@pytest.mark.parametrize("algo, config, steps", [
    ("npg", {"num_envs": 2, "hidden": [8, 8]}, 200),
    ("ppo", {"num_envs": 2, "unroll_length": 5, "num_minibatches": 2,
             "update_epochs": 1, "data_groups": 1}, 20)])
def test_train_zoo_baseline_writes_a_snapshot_the_zoo_loads(
    algo, config, steps, tmp_path, capsys):
  env_id = "hand11PoseFixed-v0"
  path = train_zoo_baseline.main([
      "--env", env_id, "--algo", algo, "--total-steps", str(steps),
      "--eval-every", "0", "--config", json.dumps(config), "--device",
      "cpu", "--zoo-dir", str(tmp_path)])
  assert path == os.path.join(str(tmp_path), f"{env_id}.pkl")
  assert "saved zoo baseline to" in capsys.readouterr().out
  metrics = json.loads((tmp_path / f"{env_id}_metrics.json").read_text())
  assert metrics["env"] == env_id and metrics["total_steps"] == steps
  assert len(metrics["history"]) == (1 if algo == "npg" else 2)
  policy = zoo.load_policy(path, device="cpu")
  assert policy.env_id == env_id
  obs = torch.as_tensor(np.random.default_rng(0).normal(size=(3, 54)))
  act = policy(obs)
  assert act.shape == (3, 21) and torch.isfinite(act).all()
  assert (act.abs() <= 1.0).all()


def test_convergence_study_prints_its_percentiles(capsys):
  it = convergence_study.main(["--env", "hand11ObjHoldRandom-v0",
                               "--batch", "8", "--steps", "7",
                               "--device", "cpu"])
  assert it.shape == (7, 8)
  out = capsys.readouterr().out
  for key in ("B=8 steps=7 cap=", "overall: p50=", "p99.9=",
              "per-step max:", "steady-state (step>=5): p99="):
    assert key in out, key
  # the hand rests on the object: the solver iterates, within its cap
  assert it.max() >= 1 and it.max() <= 100


def test_scaling_efficiency_at_two_processes(capsys):
  rows = scaling_efficiency.main(["--worlds", "2", "--iters", "1",
                                  "--device", "cpu"])
  assert [(r["algo"], r["world"]) for r in rows] == [("ppo", 2), ("npg", 2)]
  for r in rows:
    assert r["err_params"] <= 1e-9 and r["env_steps_per_s"] > 0
  out = capsys.readouterr().out
  assert "| ppo | 2 |" in out and "| npg | 2 |" in out


def test_scaling_efficiency_refuses_more_processes_than_cards():
  """The default is one process a card over NCCL: with fewer cards than
  processes it stops, and never falls back to the CPU."""
  if torch.cuda.device_count() >= 2:
    pytest.skip("this host has the cards")
  with pytest.raises(SystemExit, match="one per process"):
    scaling_efficiency.main(["--worlds", "1,2"])

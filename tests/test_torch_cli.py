"""The training CLI, the sweep and ``prove_sac`` on the CPU (``--device
cpu``), in process, on hand11 at tiny widths.

Tiny task ids are hand11's pose and reach ids with horizon 5 and
frame_skip 2, registered for each test on a copy of the registry. SAC's
defaults are cut (learning_starts 4, buffer 256, batch 8) so that its
updates run within a few iterations, and PPO's (10-step unrolls, 4
minibatches, 2 epochs) to keep the file short; the CLI's flags stay the
JAX package's (it has none for these). A resume is held to the uninterrupted
run exactly: same draws, same float32 arithmetic on the CPU.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys

import pytest
import torch

from torch_parity import assert_tree_close
from myosuite_mjx_tpu_torch.envs import registry
from myosuite_mjx_tpu_torch.tools import prove_sac
from myosuite_mjx_tpu_torch.train import checkpoint, cli, ppo, sac, sweep

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
TINY = {"hand11PoseTiny-v0": "hand11PoseFixed-v0",
        "hand11ReachTiny-v0": "hand11ReachRandom-v0"}
# per algorithm: flags of a tiny run and the env steps of one iteration
ALGOS = {
    "npg": (["--num-envs", "2", "--hidden", "8,8"], 2 * 5),
    "ppo": (["--num-envs", "2", "--hidden", "8,8"], 2 * 10),
    "sac": (["--num-envs", "2", "--hidden", "8,8"], 2),
}


@pytest.fixture(autouse=True)
def tiny_ids(monkeypatch):
  monkeypatch.setattr(registry, "_REGISTRY", dict(registry._REGISTRY))
  monkeypatch.setattr(registry, "_env_cache", {})
  for tiny, base in TINY.items():
    registry.register_env_variant(base, tiny, {"horizon": 5, "frame_skip": 2})
  monkeypatch.setattr(sac, "SACConfig", functools.partial(
      sac.SACConfig, learning_starts=4, buffer_size=256, batch_size=8))
  monkeypatch.setattr(ppo, "PPOConfig", functools.partial(
      ppo.PPOConfig, unroll_length=10, num_minibatches=2, update_epochs=2))


def _run(algo: str, iters: int, tmp, name: str, *extra,
         env="hand11ReachTiny-v0"):
  flags, per_iter = ALGOS[algo]
  argv = ["--env", env, "--algo", algo, "--device", "cpu",
          "--total-steps", str(iters * per_iter), "--log-every", "1",
          "--checkpoint-every", "2", "--checkpoint-dir",
          os.path.join(tmp, name), "--logdir", os.path.join(tmp, name, "log"),
          *flags, *extra]
  return cli.main(argv)


def _json_lines(out: str) -> list:
  return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_cli_trains_logs_and_checkpoints(algo, tmp_path, capsys):
  extra = ["--eval-every", "2"] if algo != "sac" else []
  metrics_out = tmp_path / "history.json"
  st = _run(algo, 3, str(tmp_path), "run", "--metrics-out", str(metrics_out),
            *extra)
  recs = _json_lines(capsys.readouterr().out)
  per_iter = ALGOS[algo][1]
  assert [r["iter"] for r in recs] == [1, 2, 3]
  assert [r["env_steps"] for r in recs] == [per_iter, 2 * per_iter,
                                            3 * per_iter]
  assert int(st.steps) == 3 * per_iter
  # the rate window restarts after the first iteration
  assert recs[0]["steps_per_s"] == 0.0
  assert all(r["steps_per_s"] > 0 for r in recs[1:])
  if extra:
    assert "eval_success" in recs[1] and "eval_success" in recs[2]
    assert "eval_success" not in recs[0]
  ckpts = sorted(os.listdir(tmp_path / "run"))
  assert ckpts == ["iter_0000002", "iter_0000003", "log"]
  with open(tmp_path / "run" / "log" / "metrics.jsonl") as f:
    logged = [json.loads(ln) for ln in f]
  assert [r["step"] for r in logged] == [per_iter, 2 * per_iter, 3 * per_iter]
  hist = json.loads(metrics_out.read_text())
  assert hist["args"]["algo"] == algo and len(hist["history"]) == 3


def _final(path: str):
  return torch.load(path, map_location="cpu", weights_only=True)


@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_resume_continues_and_equals_the_uninterrupted_run(algo, tmp_path,
                                                          capsys):
  tmp = str(tmp_path)
  _run(algo, 4, tmp, "straight")
  capsys.readouterr()
  _run(algo, 2, tmp, "split")
  first = _json_lines(capsys.readouterr().out)
  assert [r["iter"] for r in first] == [1, 2]
  _run(algo, 4, tmp, "split", "--resume",
       os.path.join(tmp, "split", "iter_0000002"))
  out = capsys.readouterr().out
  assert "resumed from" in out and "at iter 2" in out
  per_iter = ALGOS[algo][1]
  recs = _json_lines(out)
  assert [r["iter"] for r in recs] == [3, 4]
  assert [r["env_steps"] for r in recs] == [3 * per_iter, 4 * per_iter]
  # the checkpoints, generators included, equal the uninterrupted run's
  a = _final(os.path.join(tmp, "straight", "iter_0000004"))
  b = _final(os.path.join(tmp, "split", "iter_0000004"))
  assert_tree_close(b, a, "resumed", 0.0)
  assert not torch.equal(
      _final(os.path.join(tmp, "straight", "iter_0000002"))["generator"],
      a["generator"])
  # the log is one monotonic history
  with open(os.path.join(tmp, "split", "log", "metrics.jsonl")) as f:
    steps = [json.loads(ln)["step"] for ln in f]
  assert steps == [per_iter * k for k in (1, 2, 3, 4)]


def test_sac_resume_keeps_alpha_in_its_optimizer(tmp_path):
  """log_alpha is a bare tensor an optimizer holds: restored in place."""
  _run("sac", 4, str(tmp_path), "a")
  env = registry.make("hand11ReachTiny-v0")
  learner = sac.SAC(env, sac.SACConfig(num_envs=2, hidden=(8, 8)), "cpu")
  g = torch.Generator().manual_seed(0)
  run = {"state": learner.init(generator=g), "generator": g,
         "eval_generator": torch.Generator()}
  alpha = run["state"].log_alpha
  run = checkpoint.restore(str(tmp_path / "a" / "iter_0000004"), run)
  st = run["state"]
  assert st.log_alpha is alpha and st.log_alpha.requires_grad
  assert st.alpha_opt.param_groups[0]["params"][0] is st.log_alpha
  assert float(st.log_alpha.detach()) != 0.0 and st.steps == 8


def test_divergence_writes_an_emergency_checkpoint(tmp_path, monkeypatch):
  from myosuite_mjx_tpu_torch.train import metrics
  step = sac.SAC.train_step

  def diverging(self, ts, generator):
    ts, m = step(self, ts, generator)
    if ts.steps >= 4:
      m = {**m, "q_loss": torch.tensor(float("nan"))}
    return ts, m

  monkeypatch.setattr(sac.SAC, "train_step", diverging)
  with pytest.raises(metrics.DivergenceError, match="iter 2"):
    _run("sac", 4, str(tmp_path), "run")
  assert sorted(os.listdir(tmp_path / "run")) == ["diverged_iter_0000002",
                                                  "log"]


def test_sweep_two_seeds(tmp_path):
  out = tmp_path / "sweep"
  res = sweep.main(["--envs", "hand11ReachTiny-v0", "--seeds", "0,1",
                    "--algo", "sac", "--out", str(out), "--",
                    "--device", "cpu", "--total-steps", "6", "--num-envs",
                    "2", "--hidden", "8,8", "--log-every", "1"])
  summary = json.loads((out / "summary.json").read_text())
  assert summary == res and [r["status"] for r in summary] == ["ok", "ok"]
  assert [r["seed"] for r in summary] == [0, 1]
  for r in summary:
    d = out / f"hand11ReachTiny-v0_sac_s{r['seed']}"
    assert os.path.exists(d / "ckpt" / "iter_0000003")
    assert os.path.exists(d / "history.json")
    assert os.path.exists(d / "metrics.jsonl")


def test_sweep_keep_going_records_a_failure(tmp_path):
  out = tmp_path / "sweep"
  res = sweep.main(["--envs", "nosuch-v0,hand11ReachTiny-v0", "--algo",
                    "sac", "--out", str(out), "--keep-going", "--",
                    "--device", "cpu", "--total-steps", "2", "--num-envs",
                    "2", "--hidden", "8,8"])
  assert res[0]["status"].startswith("error:KeyError")
  assert res[1]["status"] == "ok"


def test_prove_sac_writes_its_json(tmp_path, monkeypatch):
  cfg = ('{"num_envs": 2, "updates_per_step": 2, "learning_starts": 4, '
         '"buffer_size": 64, "batch_size": 4, "hidden": [8, 8]}')
  argv = ["--env", "hand11ReachTiny-v0", "--total-steps", "8",
          "--eval-every-steps", "4", "--config", cfg, "--cpu",
          "--out", str(tmp_path)]
  res = prove_sac.main(argv)
  saved = json.loads((tmp_path / "hand11ReachTiny-v0.json").read_text())
  assert saved == json.loads(json.dumps(res))
  assert saved["config"]["hidden"] == [8, 8]
  assert [h["env_steps"] for h in saved["history"]] == [4, 8]
  for h in saved["history"]:
    assert 0.0 <= h["eval_success"] <= 1.0
    assert {"eval_solved_frac", "eval_score", "q_loss", "alpha"} <= set(h)
  # a file already under train_artifacts/ is never overwritten
  monkeypatch.setattr(prove_sac, "ARTIFACTS", str(tmp_path))
  with pytest.raises(SystemExit, match="exists under train_artifacts"):
    prove_sac.main(argv)
  assert json.loads((tmp_path / "hand11ReachTiny-v0.json").read_text()) == saved


def test_mesh_data_exits_with_its_message():
  """``--mesh data`` shards NPG and PPO (``tests/test_torch_parallel.py``);
  SAC has no data-parallel learner, and says so."""
  with pytest.raises(SystemExit, match="--mesh data shards --algo ppo and "
                                       "npg"):
    cli.main(["--env", "hand11ReachTiny-v0", "--algo", "sac", "--mesh",
              "data", "--device", "cpu"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="there is a card here")
def test_the_card_is_the_default_and_has_no_fallback():
  assert cli.build_parser().parse_args(["--env", "x"]).device == "cuda"
  with pytest.raises((RuntimeError, AssertionError)):
    cli.main(["--env", "hand11ReachTiny-v0", "--algo", "sac",
              "--total-steps", "2", "--num-envs", "2"])


def test_the_module_entry_point_trains_and_resumes(tmp_path):
  """``python -m ...train.cli`` on a registered hand11 id."""
  ck = str(tmp_path / "ck")
  base = [sys.executable, "-m", "myosuite_mjx_tpu_torch.train.cli", "--env",
          "hand11ReachRandom-v0", "--algo", "sac", "--device", "cpu",
          "--num-envs", "2", "--hidden", "8,8", "--log-every", "1",
          "--checkpoint-dir", ck, "--checkpoint-every", "2"]
  env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
  run = lambda *a: subprocess.run(base + list(a), cwd=REPO, env=env,
                                  capture_output=True, text=True,
                                  timeout=300)
  a = run("--total-steps", "4")
  assert a.returncode == 0, a.stderr
  assert [r["iter"] for r in _json_lines(a.stdout)] == [1, 2]
  b = run("--total-steps", "8", "--resume", os.path.join(ck, "iter_0000002"))
  assert b.returncode == 0, b.stderr
  assert [r["iter"] for r in _json_lines(b.stdout)] == [3, 4]
  assert sorted(os.listdir(ck)) == ["iter_0000002", "iter_0000004"]

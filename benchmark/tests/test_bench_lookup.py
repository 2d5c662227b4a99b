"""Every configuration, cell and metric that BENCHMARK.json names resolves
through the harness's own lookup by name, every file under configs/,
workloads/ and metrics/ loads, names and units keep to the allowed
characters, and a run without a card fails without a result."""
import glob
import json
import os
import subprocess
import sys

import pytest

from benchmark.harness import lookup

SPEC = lookup.bench_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_every_file_loads():
  for path in glob.glob(os.path.join(lookup.BENCH_DIR, "configs", "*.json")):
    cfg = lookup.load_json(path)
    assert os.path.exists(lookup.scene_path(cfg)), path
  for path in glob.glob(os.path.join(lookup.BENCH_DIR, "workloads", "*.json")):
    tr = lookup.load_json(path)
    assert lookup.loop(tr).run
  for path in glob.glob(os.path.join(lookup.BENCH_DIR, "metrics", "*.py")):
    name = os.path.basename(path)[:-3]
    assert callable(lookup.metric_reader(name))
    assert lookup.metric_reader(name)({}) is None


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
  cell = lookup.cell(name)
  assert cell.chips in (1, 4)
  assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
  assert len(cell.end_to_end) >= 2 and cell.per_layer
  for m in cell.per_layer:
    assert callable(lookup.metric_reader(m["name"]))
  assert cell.limits and all("limit" in v for v in cell.limits.values())


def test_names_and_units():
  names = [c["name"] for c in SPEC["configs"]] + CELLS
  names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
  names += [w["traffic"] for w in SPEC["workloads"]]
  names += [k for c in SPEC["configs"] for k in c["reduced"]]
  assert len(set(names[:len(SPEC["configs"]) + len(CELLS)])) == len(
      SPEC["configs"]) + len(CELLS)
  for n in names:
    assert lookup.NAME_RE.match(n), n
  for m in SPEC["end_to_end"] + SPEC["per_layer"]:
    assert lookup.UNIT_RE.match(m["unit"]), m
    assert m["better"] in ("lower", "higher")
  moved = {m["name"] for m in SPEC["end_to_end"]}
  assert all(m["moves"] in moved for m in SPEC["per_layer"])
  assert {c["config"] for c in SPEC["workloads"]} == {
      c["name"] for c in SPEC["configs"]}


def test_run_without_a_card_fails():
  env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
  proc = subprocess.run(
      [sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed",
       "1", "--seconds", "1", "--trace", "0"], cwd=lookup.ROOT, env=env,
      capture_output=True, text=True, timeout=300)
  assert proc.returncode != 0
  assert proc.stdout.strip() == ""
  with pytest.raises(json.JSONDecodeError):
    json.loads(proc.stdout or "x")


def test_entries_keep_the_contracts_shape():
  assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
  assert 1 <= SPEC["run_seconds"] <= 51 and SPEC["paths"] == ["benchmark"]
  for c in SPEC["configs"]:
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"].startswith("benchmark/") and len(c["why"]) <= 200
  for w in SPEC["workloads"]:
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert len(w["why"]) <= 200 and w["chips"] == 1
  for m in SPEC["end_to_end"]:
    assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                      "source"}
    assert 0.01 <= m["bound"] <= 0.25
    assert m["source"] in ("host_clock", "device_trace")
  for m in SPEC["per_layer"]:
    assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                      "layer", "moves"}

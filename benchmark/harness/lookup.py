"""Find a cell's files by name.

``BENCHMARK.json`` at the checkout's root names every configuration, cell
and metric. Each configuration's ``file`` holds its sizes and the scene it
runs; a cell's traffic is ``benchmark/workloads/<traffic>.json``; its
limits of ``correct`` are ``benchmark/limits/<cell>.json``; a per-layer
metric's reader is ``benchmark/metrics/<metric>.py``; a traffic's loop is
``benchmark/harness/loop_<loop>.py``. Adding a cell or a metric adds files
and entries; nothing here changes.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_json(path: str):
  with open(path) as f:
    return json.load(f)


def bench_spec(root: str = ROOT) -> dict:
  return load_json(os.path.join(root, "BENCHMARK.json"))


@dataclasses.dataclass
class Cell:
  name: str
  chips: int
  config: dict        # the configuration's file, with "name"
  traffic: dict       # the traffic's file, with "name"
  limits: dict        # number -> limit of ``correct``
  end_to_end: list    # the end-to-end metric entries this cell reports
  per_layer: list     # the per-layer metric entries this cell reports


def _by_name(entries: list, name: str, what: str) -> dict:
  for e in entries:
    if e["name"] == name:
      return e
  raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
  return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: str = ROOT) -> Cell:
  spec = bench_spec(root)
  w = _by_name(spec["workloads"], name, "workload")
  cfg_entry = _by_name(spec["configs"], w["config"], "config")
  config = {**load_json(os.path.join(root, cfg_entry["file"])),
            "name": cfg_entry["name"]}
  traffic = {**load_json(os.path.join(BENCH_DIR, "workloads",
                                      w["traffic"] + ".json")),
             "name": w["traffic"]}
  limits = load_json(os.path.join(BENCH_DIR, "limits", name + ".json"))
  e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
  names = {m["name"] for m in e2e}
  per_layer = [m for m in spec["per_layer"]
               if m["moves"] in names and _reports(m, name)]
  return Cell(name=name, chips=int(w["chips"]), config=config,
              traffic=traffic, limits=limits, end_to_end=e2e,
              per_layer=per_layer)


def scene_path(config: dict, root: str = ROOT) -> str:
  """The configuration's scene, a path relative to the checkout's root."""
  return os.path.join(root, config["scene"])


def loop(traffic: dict):
  """The module that drives this traffic's loop."""
  return importlib.import_module(f"benchmark.harness.loop_{traffic['loop']}")


def metric_reader(name: str):
  """The ``read(ctx)`` function of a per-layer metric's own file."""
  path = os.path.join(BENCH_DIR, "metrics", name + ".py")
  spec = importlib.util.spec_from_file_location(
      "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod.read

"""Run one cell of the port's benchmark on this machine's CUDA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The cell, its configuration, its traffic, its
limits and its per-layer metrics are found by name (``harness/lookup.py``).
The run sets up (loads the scene, makes the batch, its inputs and weights
from the seed on the card, warms the cell's own shapes), measures the
closed loop for ``--seconds`` (``--trace 0``: the end-to-end metrics) or a
short traced window (``--trace 1``: the per-layer metrics), then holds what
the timed path produced against the plain reference. It prints each number
compared beside its limit on standard error, and one JSON line last on
standard output. Without a CUDA card, or with fewer cards than the cell
asks for, it exits 2 and prints no result; it exits 3 and prints no result
if the JAX package, or JAX, was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache in the checkout, at fixed paths (the port's
# own kernel library goes to build/torch_kernels/, beside these)
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["USE_FLAX"] = "0"
if ROOT not in sys.path:
  sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "myosuite_mjx_tpu")


@dataclasses.dataclass
class Context:
  """What a loop is given: the cell, the run's arguments and the device."""
  cell: object
  seed: int
  seconds: float
  trace: bool
  device: object
  scene: str
  t0: float
  control: bool = False

  def seeds(self, n: int) -> list:
    """``n`` independent seeds derived from ``--seed``."""
    import numpy as np
    ss = np.random.SeedSequence(int(self.seed) & (2 ** 64 - 1))
    return [int(s) for s in ss.generate_state(n, dtype=np.uint64) >> 1]


def forbidden_modules() -> list:
  """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
  return sorted({m.split(".")[0] for m in list(sys.modules)}
                & set(FORBIDDEN))


def device_info(torch, dev, chips: int, memory_peak: int) -> dict:
  return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
          "count": chips, "memory_peak_bytes": int(memory_peak)}


def measure(cell, seed: int, seconds: float, trace: bool,
            control: bool = False, t0: float = T0,
            device: str = "cuda") -> dict:
  """Set up, run the cell's loop and judge it; the loop's result with
  ``correct``. The benchmark's tests pass ``device="cpu"``."""
  import torch
  from benchmark.harness import compare, lookup
  dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
  if dev.type == "cuda":
    torch.cuda.set_device(dev)
  ctx = Context(cell=cell, seed=seed, seconds=seconds, trace=trace,
                device=dev, scene=lookup.scene_path(cell.config), t0=t0,
                control=control)
  out = lookup.loop(cell.traffic).run(ctx)
  out["correct"] = compare.judge(out["numbers"], cell.limits)
  return out


def result_line(cell, out: dict, trace: bool) -> dict:
  """The last line of standard output, by the benchmark's contract."""
  import torch
  from benchmark.harness import lookup
  from benchmark.harness import trace as trace_mod
  if trace:
    metrics = {}
    ctx = {**out["layer"], "trace": out["trace"],
           "device_name": torch.cuda.get_device_name(0)}
    for m in cell.per_layer:
      value = lookup.metric_reader(m["name"])(ctx)
      if value is not None:
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
  else:
    metrics = {m["name"]: {"value": out["e2e"][m["name"]], "unit": m["unit"]}
               for m in cell.end_to_end}
  line = {"correct": bool(out["correct"]), "attempted": out["attempted"],
          "failed": out["failed"], "metrics": metrics,
          "device": device_info(torch, 0, cell.chips,
                                out["memory_peak_bytes"])}
  if trace:
    tr = out["trace"]
    line["device"]["busy_s"] = tr["busy_s"]
    line["device"]["window_s"] = tr["window_s"]
    line["breakdown"] = {"device_ops": trace_mod.top(tr["kernel_s"]),
                         "idle_gaps": trace_mod.top(tr["idle_by_host_op"])}
  line["checks"] = {k: {"value": out["numbers"][k],
                        "limit": cell.limits[k]["limit"]}
                    for k in cell.limits}
  return line


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--workload", required=True)
  ap.add_argument("--seed", type=int, required=True)
  ap.add_argument("--seconds", type=float, required=True)
  ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
  args = ap.parse_args(argv)

  from benchmark.harness import lookup
  cell = lookup.cell(args.workload)
  import torch
  # one host thread for CPU ops: the window drives the card from one thread,
  # and idle worker threads only take cores from it on a shared host
  torch.set_num_threads(1)
  if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
    print(f"benchmark: cell {cell.name} needs {cell.chips} CUDA card(s); "
          f"this machine has "
          f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
          file=sys.stderr)
    return 2
  out = measure(cell, args.seed, args.seconds, bool(args.trace))
  line = result_line(cell, out, bool(args.trace))
  from benchmark.harness import compare
  found = forbidden_modules()
  if found:
    print(f"benchmark: the run loaded {found}; the port must not load JAX "
          f"or the JAX package", file=sys.stderr)
    return 3
  others = {k: v for k, v in out["numbers"].items() if k not in cell.limits}
  print(f"readings {json.dumps(others)}", file=sys.stderr)
  for text in compare.lines(out["numbers"], cell.limits):
    print(text, file=sys.stderr)
  print(json.dumps(line))
  return 0


if __name__ == "__main__":
  sys.exit(main())

"""The import guard: nothing a benchmark run loads has the top-level name
jax, jaxlib, flax or myosuite_mjx_tpu (each compared whole, since the
port's name begins with the JAX package's), and the reference loads
nothing of the port either."""
import ast
import glob
import os
import subprocess
import sys

from benchmark.harness import lookup

FORBIDDEN = {"jax", "jaxlib", "flax", "myosuite_mjx_tpu"}
PORT = "myosuite_mjx_tpu_torch"


def _imports(path: str) -> set:
  tree = ast.parse(open(path).read())
  out = set()
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      out |= {a.name.split(".")[0] for a in node.names}
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      out.add(node.module.split(".")[0])
  return out


def _files(sub: str = "") -> list:
  return [p for p in glob.glob(os.path.join(lookup.BENCH_DIR, sub, "**",
                                            "*.py"), recursive=True)
          if os.sep + "tests" + os.sep not in p]


def test_sources_import_nothing_forbidden():
  for path in _files():
    assert not _imports(path) & FORBIDDEN, path
  for path in _files("reference"):
    assert PORT not in _imports(path), path


def _loaded_after(code: str) -> set:
  out = subprocess.run([sys.executable, "-c", code], cwd=lookup.ROOT,
                       capture_output=True, text=True, timeout=600)
  assert out.returncode == 0, out.stderr[-2000:]
  return set(out.stdout.split())


_PRINT = ("import sys; print(' '.join(sorted({m.split('.')[0] "
          "for m in sys.modules})))")


def test_reference_loads_nothing_of_the_port():
  mods = [os.path.basename(p)[:-3] for p in _files("reference")]
  code = "".join(f"import benchmark.reference.{m}; " for m in mods
                 if m != "__init__") + _PRINT
  loaded = _loaded_after(code)
  assert not loaded & (FORBIDDEN | {PORT})


def test_a_run_loads_nothing_forbidden():
  """Drive a tiny run on the CPU, then look at sys.modules."""
  code = (
      "from benchmark import run as r; from benchmark.harness import lookup\n"
      "c = lookup.cell('hand23-pose-b4096')\n"
      "c.traffic.update(batch=4, action_pool=2, warmup_steps=1,"
      " check_steps=1, check_block=4)\n"
      "r.measure(c, 3, 0.1, False, device='cpu')\n"
      "assert not r.forbidden_modules()\n" + _PRINT)
  loaded = _loaded_after(code)
  assert PORT in loaded
  assert not loaded & FORBIDDEN

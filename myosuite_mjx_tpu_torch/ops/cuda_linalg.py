"""CUDA builds and wrappers for the batched SPD-solve kernels.

Two kernels, each its own library: the register kernel (csrc/spd_solve.cu)
takes float32 with 1 <= n <= 64, the main path's solves; the general kernel
(csrc/spd_solve_general.cu) takes every other float32 or float64 solve (the
reference's unrolled ``chol_factor`` route). ``spd_solve_cuda`` picks one.

Each kernel is compiled from the package's source at first use with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library with a
plain C interface, loaded through ``ctypes``. The libraries go to
``build/torch_kernels/`` at the repo root (git-ignored) and are named by the
source's content hash, so an edited ``.cu`` is rebuilt. Nothing here runs
when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "spd_solve.cu")
GENERAL_SOURCE = os.path.join(_PKG_DIR, "csrc", "spd_solve_general.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
MAX_N = 64

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
  cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
  for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
    if cand and os.path.exists(cand):
      return cand
  raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(source: str = SOURCE) -> str:
  with open(source, "rb") as f:
    digest = hashlib.sha256(f.read()).hexdigest()[:16]
  stem = os.path.splitext(os.path.basename(source))[0]
  return os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")


def build(verbose: bool = False,
          source: str = SOURCE) -> tuple[str, float, str]:
  """Compile a kernel's source if its library is missing.

  Returns (library path, build seconds, compiler output); seconds is 0.0
  when the library was already there, and the output is then the one kept
  beside it from its build (ptxas's registers and spills).
  """
  path = library_path(source)
  log_path = path[:-len(".so")] + ".log"
  if os.path.exists(path):
    with open(log_path) as f:
      return path, 0.0, f.read()
  os.makedirs(BUILD_DIR, exist_ok=True)
  fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
  os.close(fd)
  # --split-compile=0: the kernels' instances are optimised and assembled
  # on every core (the general kernel's build: 25.5 s -> 15.3 s in
  # chip_smoke.py's phase 2 on an 8-core H100 host)
  cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
         "--split-compile=0", "-o", tmp, source]
  t0 = time.perf_counter()
  proc = subprocess.run(cmd, capture_output=True, text=True)
  seconds = time.perf_counter() - t0
  if proc.returncode != 0:
    os.unlink(tmp)
    raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
  with open(log_path, "w") as f:
    f.write(proc.stderr)
  os.replace(tmp, path)
  if verbose:
    print(proc.stderr.strip())
  return path, seconds, proc.stderr


_P, _I = ctypes.c_void_p, ctypes.c_int
# C functions of each library and their argument types
_SIGNATURES = {
    SOURCE: {"spd_solve_f32": [_P, _P, _P, _P, _I, _I, _P]},
    GENERAL_SOURCE: {"spd_solve_general_f32": [_P, _P, _P, _P, _I, _I, _I, _P],
                     "spd_solve_general_f64": [_P, _P, _P, _P, _I, _I, _I, _P],
                     "spd_solve_general_max_shared_n": [_I]},
}


def _load(source: str = SOURCE) -> ctypes.CDLL:
  if source not in _libs:
    lib = ctypes.CDLL(build(source=source)[0])
    for name, argtypes in _SIGNATURES[source].items():
      fn = getattr(lib, name)
      fn.argtypes = argtypes
      fn.restype = ctypes.c_int
    _libs[source] = lib
  return _libs[source]


def _check(a: torch.Tensor, b: torch.Tensor, who: str) -> None:
  """Raise on anything the kernels do not take: CUDA tensors on one
  device, float32 or float64 alike, a [B, n, n] and b [B, n] with n >= 1,
  contiguous."""
  if not (a.is_cuda and b.is_cuda) or a.device != b.device:
    raise ValueError(f"{who} needs CUDA tensors on one device, got "
                     f"{a.device} and {b.device}")
  if a.dtype not in (torch.float32, torch.float64) or b.dtype != a.dtype:
    raise TypeError(f"{who} takes float32 or float64 alike, got {a.dtype}, "
                    f"{b.dtype}")
  if a.ndim != 3 or a.shape[1] != a.shape[2] or b.shape != a.shape[:2]:
    raise ValueError(f"{who} needs a [B, n, n] and b [B, n], got "
                     f"{tuple(a.shape)} and {tuple(b.shape)}")
  if not (a.is_contiguous() and b.is_contiguous()):
    raise ValueError(f"{who} needs contiguous inputs")
  if b.shape[1] < 1:
    raise ValueError(f"{who} takes n >= 1, got n={b.shape[1]}")


def spd_solve_cuda(a: torch.Tensor, b: torch.Tensor, factor: bool = False):
  """Launch a kernel: x[i] = a[i]^-1 b[i] for a [B, n, n], b [B, n].

  Takes float32 or float64, contiguous CUDA tensors on one device with
  n >= 1; raises on anything else. Float32 with n <= 64 goes to the
  register kernel (counted in ``spd_solve_cuda.launches``), everything else
  to ``spd_solve_general_cuda`` (counted there). With ``factor`` it returns
  (x, L), L the lower Cholesky factor of a. Launches on the current stream
  without synchronising.
  """
  _check(a, b, "spd_solve_cuda")
  batch, n = b.shape
  if a.dtype != torch.float32 or n > MAX_N:
    return spd_solve_general_cuda(a, b, factor)
  x = torch.empty_like(b)
  L = torch.empty_like(a) if factor else None
  if batch:
    lib = _load(SOURCE)
    with torch.cuda.device(a.device):
      stream = torch.cuda.current_stream(a.device).cuda_stream
      rc = lib.spd_solve_f32(a.data_ptr(), b.data_ptr(), x.data_ptr(),
                             L.data_ptr() if factor else None, batch, n,
                             stream)
    if rc != 0:
      raise RuntimeError(f"spd_solve kernel launch failed: cudaError {rc}")
    spd_solve_cuda.launches += 1
  return (x, L) if factor else x


spd_solve_cuda.launches = 0


def spd_solve_general_cuda(a: torch.Tensor, b: torch.Tensor,
                           factor: bool = False):
  """Launch the general kernel (csrc/spd_solve_general.cu) on any float32 or
  float64 batch: a [B, n, n], b [B, n], n >= 1, contiguous, on one device;
  raises on anything else. The pivot is clamped at ``finfo(dtype).tiny``,
  as ``linalg.chol_factor``. L is always allocated (the kernel's working
  tile where a system does not fit shared memory); with ``factor`` it
  returns (x, L). Launches on the current stream without synchronising and
  counts the launch in ``spd_solve_general_cuda.launches``.
  """
  _check(a, b, "spd_solve_general_cuda")
  batch, n = b.shape
  x = torch.empty_like(b)
  L = torch.empty_like(a)
  if batch:
    lib = _load(GENERAL_SOURCE)
    fn = (lib.spd_solve_general_f64 if a.dtype == torch.float64
          else lib.spd_solve_general_f32)
    with torch.cuda.device(a.device):
      stream = torch.cuda.current_stream(a.device).cuda_stream
      rc = fn(a.data_ptr(), b.data_ptr(), x.data_ptr(), L.data_ptr(), batch,
              n, int(factor), stream)
    if rc != 0:
      raise RuntimeError(f"spd_solve_general kernel launch failed: cudaError "
                         f"{rc}")
    spd_solve_general_cuda.launches += 1
  return (x, L) if factor else x


spd_solve_general_cuda.launches = 0


def general_max_shared_n(dtype: torch.dtype) -> int:
  """The largest n whose system the general kernel stages in shared memory
  on the current card (above it the kernel works in place in L)."""
  n = _load(GENERAL_SOURCE).spd_solve_general_max_shared_n(
      torch.empty((), dtype=dtype).element_size())
  if n < 0:
    raise RuntimeError(f"reading the shared-memory limit failed: cudaError "
                       f"{-n}")
  return n

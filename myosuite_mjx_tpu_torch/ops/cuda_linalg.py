"""CUDA build and wrapper for the batched SPD-solve kernel (csrc/spd_solve.cu).

The kernel is compiled from the package's source at first use with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library with a
plain C interface, loaded through ``ctypes``. The library goes to
``build/torch_kernels/`` at the repo root (git-ignored) and is named by the
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
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
MAX_N = 64

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
  cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
  for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
    if cand and os.path.exists(cand):
      return cand
  raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> str:
  with open(SOURCE, "rb") as f:
    digest = hashlib.sha256(f.read()).hexdigest()[:16]
  return os.path.join(BUILD_DIR, f"libspd_solve_{digest}.so")


def build(verbose: bool = False) -> tuple[str, float, str]:
  """Compile the kernel if its library is missing.

  Returns (library path, build seconds, compiler output); seconds is 0.0
  when the library was already there.
  """
  path = library_path()
  if os.path.exists(path):
    return path, 0.0, ""
  os.makedirs(BUILD_DIR, exist_ok=True)
  fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
  os.close(fd)
  cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
         "-o", tmp, SOURCE]
  t0 = time.perf_counter()
  proc = subprocess.run(cmd, capture_output=True, text=True)
  seconds = time.perf_counter() - t0
  if proc.returncode != 0:
    os.unlink(tmp)
    raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
  os.replace(tmp, path)
  if verbose:
    print(proc.stderr.strip())
  return path, seconds, proc.stderr


def _load() -> ctypes.CDLL:
  global _lib
  if _lib is None:
    lib = ctypes.CDLL(build()[0])
    lib.spd_solve_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.spd_solve_f32.restype = ctypes.c_int
    _lib = lib
  return _lib


def spd_solve_cuda(a: torch.Tensor, b: torch.Tensor, factor: bool = False):
  """Launch the kernel: x[i] = a[i]^-1 b[i] for a [B, n, n], b [B, n].

  Takes float32, contiguous CUDA tensors on one device with 1 <= n <= 64;
  raises on anything else. With ``factor`` it returns (x, L), L the lower
  Cholesky factor of a. Launches on the current stream without
  synchronising and counts the launch in ``spd_solve_cuda.launches``.
  """
  if not (a.is_cuda and b.is_cuda) or a.device != b.device:
    raise ValueError(f"spd_solve_cuda needs CUDA tensors on one device, got "
                     f"{a.device} and {b.device}")
  if a.dtype != torch.float32 or b.dtype != torch.float32:
    raise TypeError(f"spd_solve_cuda takes float32, got {a.dtype}, {b.dtype}")
  if a.ndim != 3 or a.shape[1] != a.shape[2] or b.shape != a.shape[:2]:
    raise ValueError(f"spd_solve_cuda needs a [B, n, n] and b [B, n], got "
                     f"{tuple(a.shape)} and {tuple(b.shape)}")
  if not (a.is_contiguous() and b.is_contiguous()):
    raise ValueError("spd_solve_cuda needs contiguous inputs")
  batch, n = b.shape
  if not 1 <= n <= MAX_N:
    raise ValueError(f"spd_solve_cuda takes 1 <= n <= {MAX_N}, got n={n}")
  x = torch.empty_like(b)
  L = torch.empty_like(a) if factor else None
  if batch:
    lib = _load()
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

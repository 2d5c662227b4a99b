"""CUDA builds and wrappers for the port's kernels.

Four kernels, each its own library. Two solve batched SPD systems: the
register kernel (csrc/spd_solve.cu) takes float32 with 1 <= n <= 64, the
main path's solves; the general kernel (csrc/spd_solve_general.cu) takes
every other float32 or float64 solve (the reference's unrolled
``chol_factor`` route). ``spd_solve_cuda`` picks one. The third
(csrc/newton_solve.cu, ``newton_solve_cuda``) runs the constraint solve's
whole Newton loop, one env per warp, float32 or float64 with nv <= 64. The
fourth (csrc/capsule_hull.cu, ``capsule_hull_cuda``) runs a capsule-mesh
narrowphase group, one (env, pair) per warp, float32 or float64.

Each kernel is compiled from the package's source at first use with
``nvcc -gencode arch=compute_90a,code=sm_90a`` (and the source's own
``FLAGS``) into a shared library with a plain C interface, loaded through
``ctypes``. The libraries go to ``build/torch_kernels/`` at the repo root
(git-ignored) and are named by the hash of the source and its flags, so an
edited ``.cu`` is rebuilt. Nothing here runs when the module is imported.
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
NEWTON_SOURCE = os.path.join(_PKG_DIR, "csrc", "newton_solve.cu")
CAPSULE_SOURCE = os.path.join(_PKG_DIR, "csrc", "capsule_hull.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
MAX_N = 64
NEWTON_MAX_NV = 64

# nvcc flags of a source beside the common ones: the capsule kernel rounds
# every product and sum on its own, as the plain path's elementwise ops do
FLAGS = {CAPSULE_SOURCE: ("-fmad=false",)}

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
  cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
  for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
    if cand and os.path.exists(cand):
      return cand
  raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(source: str = SOURCE) -> str:
  with open(source, "rb") as f:
    digest = hashlib.sha256(
        f.read() + " ".join(FLAGS.get(source, ())).encode()).hexdigest()[:16]
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
         "--split-compile=0", *FLAGS.get(source, ()), "-o", tmp, source]
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


_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_NEWTON_ARGS = [_P] * 7 + [_I] + [_P] * 4 + [_I] * 5 + [_D, _D, _P]
_CAPSULE_ARGS = [_P] * 3 + [_I] * 2 + [_P] * 4 + [_I] + [_P] * 3 + [_I] * 2 + [
    _P]
# C functions of each library and their argument types
_SIGNATURES = {
    SOURCE: {"spd_solve_f32": [_P, _P, _P, _P, _I, _I, _P]},
    GENERAL_SOURCE: {"spd_solve_general_f32": [_P, _P, _P, _P, _I, _I, _I, _P],
                     "spd_solve_general_f64": [_P, _P, _P, _P, _I, _I, _I, _P],
                     "spd_solve_general_max_shared_n": [_I]},
    NEWTON_SOURCE: {"newton_solve_f32": _NEWTON_ARGS,
                    "newton_solve_f64": _NEWTON_ARGS,
                    "newton_solve_needs_scratch": [_I, _I, _I]},
    CAPSULE_SOURCE: {"capsule_hull_f32": _CAPSULE_ARGS,
                     "capsule_hull_f64": _CAPSULE_ARGS},
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


def newton_solve_cuda(qM: torch.Tensor, x0: torch.Tensor, ws: torch.Tensor,
                      J: torch.Tensor, aref: torch.Tensor, D: torch.Tensor,
                      is_eq: torch.Tensor, iterations: int,
                      ls_iterations: int, tol: float, ls_tol: float):
  """Launch the fused Newton kernel (csrc/newton_solve.cu): the solve of
  ``engine/solver.py`` ``_steps`` for each env, warm start to its own
  exit, its live test made every ``solver._BLOCK`` iterations (the
  kernel's ``kBlock``).

  Takes qM [B, nv, nv], x0 (qacc_smooth) and ws (the warm start) [B, nv],
  J [B, R, nv], aref and D [B, R], all float32 or all float64, and is_eq
  bool [R] or [B, R]; contiguous CUDA tensors on one device, 1 <= nv <= 64,
  none requiring grad. Raises on anything else. Returns fresh (qacc
  [B, nv], force [B, R], iterations [B] int32). Launches on the current
  stream without synchronising and counts the launch in
  ``newton_solve_cuda.launches``.
  """
  tensors = (qM, x0, ws, J, aref, D, is_eq)
  if not all(t.is_cuda for t in tensors) or len(
      {t.device for t in tensors}) != 1:
    raise ValueError("newton_solve_cuda needs CUDA tensors on one device, "
                     f"got {sorted({str(t.device) for t in tensors})}")
  dtype = J.dtype
  if dtype not in (torch.float32, torch.float64) or any(
      t.dtype != dtype for t in tensors[:6]) or is_eq.dtype != torch.bool:
    raise TypeError("newton_solve_cuda takes float32 or float64 alike and a "
                    f"bool is_eq, got {[t.dtype for t in tensors]}")
  if J.ndim != 3:
    raise ValueError(f"newton_solve_cuda needs J [B, R, nv], got "
                     f"{tuple(J.shape)}")
  B, R, nv = J.shape
  shapes = ((qM, (B, nv, nv)), (x0, (B, nv)), (ws, (B, nv)),
            (aref, (B, R)), (D, (B, R)))
  if (not 1 <= nv <= NEWTON_MAX_NV or any(tuple(t.shape) != s
                                          for t, s in shapes)
      or tuple(is_eq.shape) not in ((R,), (B, R))):
    raise ValueError("newton_solve_cuda needs qM [B, nv, nv], x0 and ws "
                     "[B, nv], J [B, R, nv], aref and D [B, R], is_eq [R] or "
                     f"[B, R], 1 <= nv <= {NEWTON_MAX_NV}; got "
                     f"{[tuple(t.shape) for t in tensors]}")
  if not all(t.is_contiguous() for t in tensors):
    raise ValueError("newton_solve_cuda needs contiguous inputs")
  if any(t.requires_grad for t in tensors):
    raise ValueError("newton_solve_cuda takes no input that requires grad")
  qacc = torch.empty_like(x0)
  force = J.new_empty((B, R))
  its = torch.empty((B,), dtype=torch.int32, device=J.device)
  if B:
    lib = _load(NEWTON_SOURCE)
    # the rows' scratch, only where one env's rows overflow shared memory
    rows = (J.new_empty((B, 2, R))
            if lib.newton_solve_needs_scratch(R, nv, J.element_size())
            else None)
    fn = (lib.newton_solve_f64 if dtype == torch.float64
          else lib.newton_solve_f32)
    with torch.cuda.device(J.device):
      stream = torch.cuda.current_stream(J.device).cuda_stream
      rc = fn(*(t.data_ptr() for t in (qM, x0, ws, J, aref, D, is_eq)),
              R if is_eq.ndim == 2 else 0,
              *(t.data_ptr() for t in (qacc, force, its)),
              None if rows is None else rows.data_ptr(),
              B, R, nv, iterations, ls_iterations, tol, ls_tol, stream)
    if rc != 0:
      raise RuntimeError(f"newton_solve kernel launch failed: cudaError {rc}")
    newton_solve_cuda.launches += 1
  return qacc, force, its


newton_solve_cuda.launches = 0


def capsule_hull_cuda(p1: torch.Tensor, m1: torch.Tensor, s1: torch.Tensor,
                      p2: torch.Tensor, m2: torch.Tensor, tris: torch.Tensor,
                      eqs: torch.Tensor):
  """Launch the capsule-mesh kernel (csrc/capsule_hull.cu): the whole of
  ``engine/collision.py`` ``_capsule_hull`` for one type group, each
  (env, pair) its own warp.

  Takes the capsules' p1 [..., 3], m1 [..., 3, 3] and sizes s1 [..., 3]
  (radius, half length; any strides, the expanded static sizes among
  them), the hulls' p2 [..., 3] and m2 [..., 3, 3] over the same leading
  dims (a group's [B, G]), and the group's hull, tris [F, 3, 3] and eqs
  [F, 4] with F >= 1; all float32 or all float64, CUDA tensors on one
  device, none requiring grad. Raises on anything else. Returns fresh
  (dist [..., 1], pos [..., 1, 3], n [..., 1, 3]), what
  ``_one(_capsule_hull)`` returns. Launches on the current stream without
  synchronising and counts the launch in ``capsule_hull_cuda.launches``.
  """
  tensors = (p1, m1, s1, p2, m2, tris, eqs)
  if not all(t.is_cuda for t in tensors) or len(
      {t.device for t in tensors}) != 1:
    raise ValueError("capsule_hull_cuda needs CUDA tensors on one device, "
                     f"got {sorted({str(t.device) for t in tensors})}")
  dtype = p1.dtype
  if dtype not in (torch.float32, torch.float64) or any(
      t.dtype != dtype for t in tensors):
    raise TypeError("capsule_hull_cuda takes float32 or float64 alike, got "
                    f"{[t.dtype for t in tensors]}")
  lead = tuple(p1.shape[:-1])
  F = tris.shape[0] if tris.ndim else 0
  shapes = ((p1, lead + (3,)), (m1, lead + (3, 3)), (s1, lead + (3,)),
            (p2, lead + (3,)), (m2, lead + (3, 3)), (tris, (F, 3, 3)),
            (eqs, (F, 4)))
  if F < 1 or any(tuple(t.shape) != s for t, s in shapes):
    raise ValueError("capsule_hull_cuda needs p1, s1 and p2 [..., 3], m1 and "
                     "m2 [..., 3, 3] over the same leading dims, tris "
                     f"[F, 3, 3] and eqs [F, 4] with F >= 1; got "
                     f"{[tuple(t.shape) for t in tensors]}")
  if any(t.requires_grad for t in tensors):
    raise ValueError("capsule_hull_cuda takes no input that requires grad")
  if len(lead) != 2:
    # one pair an env: [N, 1]
    p1, s1, p2 = (t.reshape(-1, 1, 3) for t in (p1, s1, p2))
    m1, m2 = (t.reshape(-1, 1, 3, 3) for t in (m1, m2))
  if s1.stride(2) != 1:
    s1 = s1.contiguous()
  p1, m1, p2, m2, tris, eqs = (t.contiguous()
                               for t in (p1, m1, p2, m2, tris, eqs))
  B, G = p1.shape[:2]
  dist = p1.new_empty(lead + (1,))
  pos = p1.new_empty(lead + (1, 3))
  n = p1.new_empty(lead + (1, 3))
  if B and G:
    lib = _load(CAPSULE_SOURCE)
    fn = (lib.capsule_hull_f64 if dtype == torch.float64
          else lib.capsule_hull_f32)
    with torch.cuda.device(p1.device):
      stream = torch.cuda.current_stream(p1.device).cuda_stream
      rc = fn(p1.data_ptr(), m1.data_ptr(), s1.data_ptr(), s1.stride(0),
              s1.stride(1), p2.data_ptr(), m2.data_ptr(), tris.data_ptr(),
              eqs.data_ptr(), F, dist.data_ptr(), pos.data_ptr(),
              n.data_ptr(), B, G, stream)
    if rc != 0:
      raise RuntimeError(f"capsule_hull kernel launch failed: cudaError {rc}")
    capsule_hull_cuda.launches += 1
  return dist, pos, n


capsule_hull_cuda.launches = 0

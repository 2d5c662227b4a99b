"""The fused Newton kernel (``csrc/newton_solve.cu``) and the solver's
route to it.

On the CPU: the route is a pure function of device, dtype, nv, grad and a
capture under way (the CPU, grad and a capture take the eager loop, nv > 64
the graph-replayed blocks, float32 and float64 with nv <= 64 on the card
the kernel); a CPU solve counts nothing as fused; the wrapper refuses CPU
tensors before it builds anything; the source carries its note and builds
the instances the route asks for. Without a card the rest skips: the kernel
has no CPU mode. Imports no jax, so it runs on the GPU machine too:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_newton_kernel.py

On the card the kernel is held to the eager loop (``_steps``, the CPU
path) on the Newton solves of two control steps at B 4096 of hand23 pose
([4096, 119, 23]: contact rows in force) and legs80 walk on MyoLeg's knees
([4096, 138, 34]: the knees' 14 equality rows, the feet's contacts, the
reset's own solve), and on a fall of prims36's six free bodies onto the
floor ([4096, 240, 36], every pair type), in float32 and float64; on the
legs80 solves with their rows repeated three times (R 414, kept in shared
memory) and 150 times (R 20,700, past it: the kernel's scratch); with the
iteration cap at 0 (every env exits in the prologue, on the warm start or
on qacc_smooth as the costs decide) and at 1 and 3 (an odd cap ends
mid-block, as in the reference); and with a warm start far off, so that
qacc_smooth is taken. The float32 kernel is also held, beside the eager
float32 loop, to the eager loop run in float64 on the same values. A
1-env and a 4097-env batch give the 4096 batch's bits; the wrapper raises
on what it does not take and allocates the rows' scratch only past shared
memory; repeated launches give the same bits, and CUDA events time the
kernel against the graph path it replaces.
"""
from __future__ import annotations

import os
import re

import numpy as np
import pytest
import torch

from myosuite_mjx_tpu_torch.engine import solver
from myosuite_mjx_tpu_torch.ops import cuda_linalg
from myosuite_mjx_tpu_torch.utils import spans

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "myosuite_mjx_tpu_torch", "assets")


@pytest.mark.parametrize("device,dtype,nv,grad,capturing,expected", [
    ("cpu", torch.float32, 23, False, False, solver.EAGER),
    ("cpu", torch.float64, 72, False, False, solver.EAGER),
    ("cuda", torch.float32, 23, True, False, solver.EAGER),
    ("cuda", torch.float32, 23, False, True, solver.EAGER),
    ("cuda", torch.float32, 65, False, False, solver.STAGED),
    ("cuda", torch.float64, 72, False, False, solver.STAGED),
    ("cuda", torch.float16, 23, False, False, solver.STAGED),
    ("cuda", torch.float32, 1, False, False, solver.KERNEL),
    ("cuda", torch.float32, 23, False, False, solver.KERNEL),
    ("cuda", torch.float32, 34, False, False, solver.KERNEL),
    ("cuda", torch.float64, 34, False, False, solver.KERNEL),
    ("cuda", torch.float64, 64, False, False, solver.KERNEL),
])
def test_route_is_a_function_of_what_the_inputs_show(device, dtype, nv, grad,
                                                     capturing, expected):
  assert solver.route(device, dtype, nv, grad, capturing) == expected


def _cpu_solve():
  """One hand23 pose solve on the CPU at B 2: (m, d, J, aref, D, is_eq)."""
  from myosuite_mjx_tpu_torch import envs
  env = envs.make("hand23PoseFixed-v0")
  st = env.reset(2, "cpu")
  rec = []
  inner = solver._newton_solve

  def recorded(*args):
    rec.append(args)
    return inner(*args)

  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(solver, "_newton_solve", recorded)
    env.autoreset_step(st, torch.zeros((2, env.action_dim)))
  return rec[-1]


def test_a_cpu_solve_takes_the_eager_loop_and_counts_nothing_fused():
  args = _cpu_solve()
  launches = cuda_linalg.newton_solve_cuda.launches
  syncs = solver.newton_host_syncs.count
  with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
    qacc, force, iterations = solver._newton_solve(*args)
    assert spans.newton_fused_solves() == (0, 0)
    blocks = spans.newton_graph_blocks()
  assert cuda_linalg.newton_solve_cuda.launches == launches
  assert solver.newton_host_syncs.count - syncs == blocks[1] + 1
  assert blocks[0] == 0 and int(iterations.max()) == solver._BLOCK * blocks[1]


def test_the_wrapper_refuses_cpu_tensors_before_building():
  m, d, J, aref, D, is_eq, _, _ = _cpu_solve()
  with pytest.raises(ValueError, match="CUDA"):
    cuda_linalg.newton_solve_cuda(d.qM, d.qacc_smooth, d.qacc_warmstart, J,
                                  aref, D, is_eq, 100, 50, 1e-8, 0.01)


def test_the_source_has_its_note_and_the_routes_instances():
  with open(cuda_linalg.NEWTON_SOURCE) as f:
    src = f.read()
  note = src.split("#include")[0]
  for words in ("Replaces no Pallas kernel", "What bounds it", "3.35 TB/s",
                "One warp per env", "IEEE division"):
    assert words in note, words
  # the instances: slots of 32 entries a lane, up to the route's nv
  slots = sorted(int(k) for k in re.findall(r"launch<T, (\d+)>\(pr", src))
  assert [32 * s for s in slots] == [32, cuda_linalg.NEWTON_MAX_NV]
  assert f"nv > {cuda_linalg.NEWTON_MAX_NV}" in src
  exported = set(re.findall(r'extern "C" int (\w+)\(', src))
  assert exported == set(cuda_linalg._SIGNATURES[cuda_linalg.NEWTON_SOURCE])
  # the iterations between two exit tests: the kernel's constant is the
  # solver's, and no launch carries it
  assert re.findall(r"constexpr int kBlock = (\d+);", src) == [
      str(solver._BLOCK)]
  assert "block" not in "".join(re.findall(
      r'extern "C" int newton_solve_f\d\d\(([^)]*)\)', src))
  # the SPD kernel's roofline reads kernels by this name: not this one's
  assert "spd_solve_kernel" not in src
  assert re.search(r"__global__ void __launch_bounds__\([^)]*\)\s+"
                   r"newton_solve_kernel\(", src)


# ---- on the card ----

BATCH = 4096


def _hand23_pose(dtype):
  from myosuite_mjx_tpu_torch.envs.pose import HAND_POSE_FIXED, PoseEnv
  return PoseEnv(os.path.join(ASSETS, "hand23.npz"), dtype=dtype,
                 **HAND_POSE_FIXED)


def _legs80_walk(dtype):
  from myosuite_mjx_tpu_torch import envs
  return envs.make("legs80Walk-v0", dtype=dtype,
                   model_path=os.path.join(ASSETS, "legs80_knee.npz"))


def _kept(args) -> tuple:
  """``_newton_solve``'s arguments, copied: the rows come from a graph's
  buffers, which the next replay overwrites."""
  m, d, J, aref, D, is_eq, its, ls_its = args
  d = d.replace(qM=d.qM.clone(), qacc_smooth=d.qacc_smooth.clone(),
                qacc_warmstart=d.qacc_warmstart.clone())
  return (m, d, J.clone(), aref.clone(), D.clone(), is_eq.clone(), its,
          ls_its)


def _env_solves(make_env, dtype) -> list:
  """The Newton solves of two control steps at B 4096 (the walk's resets
  included), as ``_newton_solve``'s arguments."""
  from myosuite_mjx_tpu_torch.envs.base import BatchedEnv
  benv = BatchedEnv(make_env(dtype), BATCH, "cuda")
  g = torch.Generator(device="cuda").manual_seed(0)
  st = benv.init()
  rec = []
  inner = solver._newton_solve

  def recorded(*args):
    rec.append(_kept(args))
    return inner(*args)

  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(solver, "_newton_solve", recorded)
    for _ in range(2):
      a = torch.rand((BATCH, benv.env.action_dim), generator=g,
                     device="cuda", dtype=dtype) * 2 - 1
      st = benv.step(st, a)
  return rec


def _prims36_solves(dtype) -> list:
  """The solves of prims36's six free bodies falling for 40 substeps,
  each env from its own random velocities; the last 4 kept."""
  from myosuite_mjx_tpu_torch.engine import api
  phys = api.load(os.path.join(ASSETS, "prims36.npz"), dtype, "cuda")
  d = phys.make_data(BATCH)
  g = torch.Generator(device="cuda").manual_seed(0)
  d = d.replace(qvel=torch.randn(d.qvel.shape, generator=g, device="cuda",
                                 dtype=dtype))
  rec = []
  inner = solver._newton_solve

  def recorded(*args):
    rec.append(_kept(args))
    return inner(*args)

  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(solver, "_newton_solve", recorded)
    for _ in range(40):
      d = phys.step(d)
  return rec[-4:]


SCENES = {"hand23": lambda dt: _env_solves(_hand23_pose, dt),
          "legs80": lambda dt: _env_solves(_legs80_walk, dt),
          "prims36": _prims36_solves}
_solves: dict = {}


def _scene(name: str, dtype) -> list:
  if (name, dtype) not in _solves:
    _solves[(name, dtype)] = SCENES[name](dtype)
  return _solves[(name, dtype)]


def _run(args, how, iterations=None, ws=None):
  """``_newton_solve`` on ``args`` by the route ``how``, with the cap or
  the warm start replaced."""
  m, d, J, aref, D, is_eq, its, ls_its = args
  if ws is not None:
    d = d.replace(qacc_warmstart=ws)
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(solver, "route", lambda *a: how)
    out = solver._newton_solve(m, d, J, aref, D, is_eq,
                               its if iterations is None else iterations,
                               ls_its)
  torch.cuda.synchronize()
  return out


# Tolerances, kernel against the eager loop. Both run the same arithmetic
# in the same precision, the sums in other orders (warp butterflies against
# cuBLAS and ATen reductions) and with FMA contraction, so each solution
# moves by ~eps x the condition of the env's H. Per env, the error is the
# largest gap over qacc (or force) over the eager side's largest magnitude
# in that env (floor: 1e-6 of the solve's). Three statistics of the envs'
# errors are bounded: the median, the 0.999 quantile and the largest. A
# force is -D jar with jar = J qacc - aref cancelling on a row in contact,
# so its errors run above qacc's. The readings each bound was set from are
# the largest over every solve of the hand23, legs80 and prims36 scenes
# below (NVIDIA H100 80GB HBM3, float32 / float64):
#   median   float32 3.3e-7 (legs80 qacc)     float64 1.2e-15
#   0.999    float32 2.2e-3 (prims36 force)   float64 4.2e-14
#   largest  float32 7.6e-3 (legs80 qacc)     float64 9.7e-14
# and each bound leaves 3-10x above its reading. The bounds grow with the
# rows a sum runs over, so a solve whose rows are repeated k times takes
# k times each (the readings at k = 3 and 150 below: median 7.2e-7 and
# 2.6e-5, 0.999 2.5e-3 and 1.1e-4, largest 4.1e-3 and 1.1e-4 in float32;
# largest 2.9e-14 and 1.9e-13 in float64). In float64 the iteration
# counts agree (the readings: in every env). In float32 an env converged
# to rounding has a last improvement that is rounding noise of its cost,
# and on the walk that noise exceeds tol, so the block-end test is a coin
# toss on both sides and may let it run a block more on one: the counts
# agree in at least 70% of the envs (the readings: 79.8% at worst, on the
# walk; 13 of 16 envs at R 20,700) and differ by at most two blocks, and
# the bounds above hold all the same.
MEDIAN = {torch.float32: 3e-6, torch.float64: 1e-14}
TAIL = {torch.float32: 8e-3, torch.float64: 2e-13}
LARGEST = {torch.float32: 3e-2, torch.float64: 5e-13}
SAME_ITERATIONS = {torch.float32: 0.7, torch.float64: 0.999}


def _env_error(a: torch.Tensor, b: torch.Tensor) -> np.ndarray:
  a, b = a.double(), b.double()
  scale = b.abs().amax(-1).clamp(min=1e-6 * float(b.abs().max()) + 1e-300)
  return ((a - b).abs().amax(-1) / scale).cpu().numpy()


def _spread(err: np.ndarray) -> tuple:
  """(median, 0.999 quantile, largest) of the envs' errors."""
  return (float(np.median(err)), float(np.quantile(err, 0.999)),
          float(err.max()))


def _check(kernel, eager, dtype, what: str, scale: float = 1.0) -> dict:
  stats = {}
  for a, b, name in zip(kernel[:2], eager[:2], ("qacc", "force")):
    err = _env_error(a, b)
    stats[name] = _spread(err)
  same = float((kernel[2] == eager[2]).double().mean())
  stats["same_iterations"] = same
  stats["largest_iteration_gap"] = int((kernel[2] - eager[2]).abs().max())
  print(f"{what} {dtype}: {stats}")
  for name in ("qacc", "force"):
    for got, bound in zip(stats[name], (MEDIAN, TAIL, LARGEST)):
      assert got <= scale * bound[dtype], (what, name, stats[name])
  assert same >= SAME_ITERATIONS[dtype], (what, stats)
  assert stats["largest_iteration_gap"] <= 2 * solver._BLOCK, (what, stats)
  assert kernel[0].shape == eager[0].shape
  assert kernel[1].shape == eager[1].shape
  assert kernel[2].dtype == torch.int32
  return stats


def _skip_without_card():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_fused_kernel_matches_the_eager_loop_on_card(dtype, scene):
  _skip_without_card()
  solves = _scene(scene, dtype)
  assert solves and solves[0][2].shape[0] == BATCH
  launches = cuda_linalg.newton_solve_cuda.launches
  syncs = solver.newton_host_syncs.count
  rows = 0
  for k, args in enumerate(solves):
    kernel = _run(args, solver.KERNEL)
    assert solver.newton_host_syncs.count == syncs
    eager = _run(args, solver.EAGER)
    syncs = solver.newton_host_syncs.count
    _check(kernel, eager, dtype, f"{scene} solve {k} {tuple(args[2].shape)}")
    rows += int((eager[1] != 0).sum())
  assert cuda_linalg.newton_solve_cuda.launches - launches == len(solves)
  assert rows > 0
  if scene == "legs80":
    J, is_eq = solves[0][2], solves[0][5]
    assert int(is_eq.sum()) == 14 and J.shape[1:] == (138, 34)
    # the equality rows hold force
    assert (_run(solves[-1], solver.KERNEL)[1][:, :14] != 0).any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_fused_kernel_caps_prologue_exits_and_warm_starts(dtype):
  _skip_without_card()
  args = _scene("hand23", dtype)[-1]
  d = args[1]
  # cap 0: every env exits in the prologue, on whichever start costs less
  kernel = _run(args, solver.KERNEL, iterations=0)
  eager = _run(args, solver.EAGER, iterations=0)
  assert int(kernel[2].abs().max()) == 0
  on_ws = (kernel[0] == d.qacc_warmstart).all(-1)
  on_x0 = (kernel[0] == d.qacc_smooth).all(-1)
  assert bool((on_ws | on_x0).all())
  # both starts taken somewhere, and the same one as the eager loop's but
  # where the two costs tie within rounding; where the two took the same
  # start, the same qacc bit for bit (a tie's other start is no error)
  assert bool(on_ws.any()) and bool(on_x0.any())
  agree = on_ws == (eager[0] == d.qacc_warmstart).all(-1)
  assert float(agree.double().mean()) >= SAME_ITERATIONS[dtype]
  assert torch.equal(kernel[0][agree], eager[0][agree])
  _check(tuple(t[agree] for t in kernel), tuple(t[agree] for t in eager),
         dtype, "cap 0, the same start")
  # odd caps end mid-block: the test runs at block ends only
  for cap in (1, 3):
    kernel = _run(args, solver.KERNEL, iterations=cap)
    eager = _run(args, solver.EAGER, iterations=cap)
    assert int(kernel[2].max()) == cap + 1
    _check(kernel, eager, dtype, f"cap {cap}")
  # a warm start far off: every env starts from qacc_smooth
  far = d.qacc_smooth + 100.0
  kernel = _run(args, solver.KERNEL, iterations=0, ws=far)
  assert torch.equal(kernel[0], d.qacc_smooth)
  kernel = _run(args, solver.KERNEL, ws=far)
  eager = _run(args, solver.EAGER, ws=far)
  _check(kernel, eager, dtype, "far warm start")


@pytest.mark.gpu
@pytest.mark.parametrize("copies,batch", [(3, BATCH), (150, 16)],
                         ids=["R414-shared", "R20700-scratch"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_fused_kernel_on_300_and_more_rows(dtype, copies, batch):
  """The walk's last solve with its rows repeated: 414 rows, which each
  warp keeps in shared memory, and 20,700, whose rows no warp's shared
  memory holds (the kernel keeps them in its scratch)."""
  _skip_without_card()
  m, d, J, aref, D, is_eq, its, ls_its = _scene("legs80", dtype)[-1]
  d = d.replace(qM=d.qM[:batch], qacc_smooth=d.qacc_smooth[:batch],
                qacc_warmstart=d.qacc_warmstart[:batch])
  tiled = (m, d, J[:batch].repeat(1, copies, 1).contiguous(),
           aref[:batch].repeat(1, copies), D[:batch].repeat(1, copies),
           is_eq.repeat(copies), its, ls_its)
  assert tiled[2].shape[1] == 138 * copies >= 300
  # the wrapper allocates the rows' scratch only where shared memory is short
  lib = cuda_linalg._load(cuda_linalg.NEWTON_SOURCE)
  assert lib.newton_solve_needs_scratch(
      138 * copies, 34, J.element_size()) == int(copies == 150)
  kernel = _run(tiled, solver.KERNEL)
  eager = _run(tiled, solver.EAGER)
  _check(kernel, eager, dtype, f"legs80 rows x{copies} at B {batch}",
         scale=copies)


def _float64(args) -> tuple:
  """``_newton_solve``'s arguments in float64: the same values, widened."""
  m, d, J, aref, D, is_eq, its, ls_its = args
  d = d.replace(qM=d.qM.double(), qacc_smooth=d.qacc_smooth.double(),
                qacc_warmstart=d.qacc_warmstart.double())
  return (m, d, J.double(), aref.double(), D.double(), is_eq, its, ls_its)


# Float32 against a float64 reference: the kernel in float32 and the eager
# loop in float32, each against the eager loop run in float64 on the same
# values widened. Both float32 sides carry float32's rounding, amplified by
# each env's condition, so the kernel is held to the eager loop's own
# errors: each statistic of its envs' errors (median, 0.999 quantile,
# largest) at most RATIO_TO_EAGER times the eager float32 loop's, plus
# float32's eps for a statistic that reads near zero on both sides. A
# fault of the float32 instances alone (a sum, a pivot or a rounding of
# their own) shows here against values that are not float32 themselves.
# The readings (NVIDIA H100 80GB HBM3): the kernel's statistics at
# 0.75-1.47x the eager loop's, the largest ratio at legs80's largest force
# error (4.3e-3 against 2.9e-3); qacc's largest 7.6e-3 on the eager side
# and 6.8e-3 on the kernel's.
RATIO_TO_EAGER = 3.0


@pytest.mark.gpu
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_fused_kernel_float32_against_a_float64_eager_loop(scene):
  _skip_without_card()
  stats = {"kernel": {"qacc": [], "force": []},
           "eager": {"qacc": [], "force": []}}
  for args in _scene(scene, torch.float32):
    kernel = _run(args, solver.KERNEL)
    eager = _run(args, solver.EAGER)
    ref = _run(_float64(args), solver.EAGER)
    for side, out in (("kernel", kernel), ("eager", eager)):
      for k, name in enumerate(("qacc", "force")):
        stats[side][name].append(_env_error(out[k], ref[k]))
  spread = {side: {name: _spread(np.concatenate(errs))
                   for name, errs in v.items()}
            for side, v in stats.items()}
  print(f"{scene} float32 against float64, over "
        f"{len(stats['kernel']['qacc'])} solves: {spread}")
  for name in ("qacc", "force"):
    for got, eager in zip(spread["kernel"][name], spread["eager"][name]):
      assert got <= (RATIO_TO_EAGER * eager
                     + torch.finfo(torch.float32).eps), (scene, name, spread)


@pytest.mark.gpu
def test_fused_kernel_batch_sizes_agree():
  """Each env's solve depends on that env alone: a 1-env batch, the 4096
  batch and a 4097-env batch (the 4096 and env 0 again) give its bits."""
  _skip_without_card()
  args = _scene("hand23", torch.float32)[-1]
  m, d, J, aref, D, is_eq, its, ls_its = args
  inputs, rest = solver._problem(m, d, J, aref, D, is_eq, its, ls_its)
  full = cuda_linalg.newton_solve_cuda(*inputs, *rest)
  one = cuda_linalg.newton_solve_cuda(
      *(t[:1].contiguous() for t in inputs[:6]), inputs[6], *rest)
  more = cuda_linalg.newton_solve_cuda(
      *(torch.cat([t, t[:1]]) for t in inputs[:6]), inputs[6], *rest)
  torch.cuda.synchronize()
  for f, o, x in zip(full, one, more):
    assert torch.equal(o[0], f[0])
    assert torch.equal(x[:BATCH], f) and torch.equal(x[BATCH], f[0])


@pytest.mark.gpu
def test_fused_kernel_rejects_what_it_does_not_take():
  _skip_without_card()
  m, d, J, aref, D, is_eq, its, ls_its = _scene("hand23", torch.float32)[-1]
  inputs, rest = solver._problem(m, d, J, aref, D, is_eq, its, ls_its)
  qM, x0, ws, J, aref, D, is_eq = inputs

  def call(*tensors):
    return cuda_linalg.newton_solve_cuda(*tensors, *rest)

  with pytest.raises(TypeError):
    call(qM.half(), x0.half(), ws.half(), J.half(), aref.half(), D.half(),
         is_eq)
  with pytest.raises(TypeError):
    call(qM.double(), x0, ws, J, aref, D, is_eq)
  with pytest.raises(TypeError):
    call(qM, x0, ws, J, aref, D, is_eq.to(torch.uint8))
  with pytest.raises(ValueError, match="CUDA"):
    call(qM.cpu(), x0, ws, J, aref, D, is_eq)
  with pytest.raises(ValueError):
    call(qM, x0, ws, J[:, :-1], aref, D, is_eq)
  with pytest.raises(ValueError):
    call(qM, x0, ws, J, aref, D, is_eq[:-1])
  big = J.new_zeros((2, 65, 65))
  with pytest.raises(ValueError):
    call(big, J.new_zeros((2, 65)), J.new_zeros((2, 65)),
         J.new_zeros((2, 3, 65)), J.new_zeros((2, 3)), J.new_zeros((2, 3)),
         is_eq[:3])
  with pytest.raises(ValueError, match="contiguous"):
    call(qM.transpose(1, 2), x0, ws, J, aref, D, is_eq)
  with pytest.raises(ValueError, match="grad"):
    call(qM, x0.clone().requires_grad_(), ws, J, aref, D, is_eq)


def _events_us(fn, reps: int) -> float:
  """us per call: CUDA events around ``reps`` calls, after a warm-up."""
  for _ in range(3):
    fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return 1e3 * start.elapsed_time(end) / reps


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["hand23", "legs80"])
def test_fused_kernel_repeats_its_bits_and_is_timed(scene):
  """Ten launches on one solve give the same bits; CUDA events time the
  kernel and the graph path it replaces (warmed up, then replays: one
  sync a block) on that solve, float32, against the bytes-once bound."""
  _skip_without_card()
  args = _scene(scene, torch.float32)[-1]
  first = _run(args, solver.KERNEL)
  for _ in range(9):
    again = _run(args, solver.KERNEL)
    for a, b in zip(first, again):
      assert torch.equal(a, b)
  m, d, J, aref, D, is_eq, its, ls_its = args
  inputs, rest = solver._problem(m, d, J, aref, D, is_eq, its, ls_its)
  kernel_us = _events_us(lambda: cuda_linalg.newton_solve_cuda(
      *inputs, *rest), 50)
  graph_us = _events_us(lambda: _run(args, solver.STAGED), 10)
  B, R, nv = J.shape
  size = J.element_size()
  moved = B * size * (nv * nv + 2 * nv + R * nv + 2 * R    # read once
                      + nv + R) + B * 4                    # written
  bound_us = 1e6 * moved / 3.35e12
  print(f"newton kernel {scene} [{B}, {R}, {nv}] float32: {kernel_us:.1f} "
        f"us a solve (graph path {graph_us:.1f} us); bound {bound_us:.1f} us "
        f"({moved / 1e6:.1f} MB once), {bound_us / kernel_us:.3f} of it; "
        f"iterations max {int(first[2].max())}, mean "
        f"{float(first[2].float().mean()):.2f}")
  assert kernel_us > 0 and graph_us > 0

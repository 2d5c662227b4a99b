"""The CUDA SPD-solve kernels against their plain PyTorch version, on a card.

Imports no jax, so it runs on the GPU machine too:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_kernel_gpu.py

Without a card every case skips: the kernels have no CPU mode. For the
register kernel (float32, n <= 64) the sizes cover every padded size it is
built for (8, 16, 24, 32, 64), both ends of each, and n = 1; the batches
cover a single system, whole blocks (the bulk-copy load) and a ragged last
block (the plain load). For the general kernel the sizes cover both ends of
each padded size of its float64 register route (8, 16, 24, 32, 48, 64) and
both sides of each route switch (64 / 65 to the shared tile, its
shared-memory limit: n 168 / 169 in float64, 240 / 241 in float32 on an
H100), with and without the factor, at one system, B = 16, 4096 and 4097;
misaligned views (the plain loads); the clamp cases (pivots that reach 0 or
go below tiny); and the entry points that run through it: a float64
``MyoEnv`` and ``Physics`` on chain72 (nv 72), each against the CPU.
The Newton solve replayed from its CUDA graphs (the path of nv > 64,
forced here) against the same solves run eagerly, bit for bit, in float32
and float64, on hand23 pose and on legs80 walk on MyoLeg's knees
(equality and contact rows in force); so are three autoreset steps of
each through the forward's graphs (Newton in the fused kernel,
``tests/test_torch_newton_kernel.py``, on both sides), and an env gives
one ``DeviceModel`` for ``"cuda"`` and ``"cuda:0"``. Last,
the rest of the port on the card against the CPU: the reflex controller's
update, the gym adapter, the CNN encoder, and the data-parallel learners
at world size 1 on NCCL against the plain step.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch

from myosuite_mjx_tpu_torch.engine import api
from myosuite_mjx_tpu_torch.envs.base import BatchedEnv
from myosuite_mjx_tpu_torch.envs.pose import HAND_POSE_FIXED, PoseEnv
from myosuite_mjx_tpu_torch.ops import cuda_linalg, linalg

SIZES = (1, 4, 8, 11, 16, 17, 23, 24, 32, 33, 64)
BATCHES = (1, 1000, 4096, 4097)
# float32 on both sides, other operation order: a few ulps of the scale
BOUND = 2e-5
# the general kernel: float64 at any n, float32 with n > 64 through the
# dispatch, and float32 at any n through spd_solve_general_cuda itself
GENERAL_F64_SIZES = (1, 7, 8, 9, 16, 17, 23, 24, 25, 32, 33, 35, 48, 49, 50,
                     64, 65, 72, 128, 168, 169, 170, 200)
GENERAL_F32_SIZES = (65, 72, 128, 239, 240, 241, 256)
GENERAL_F32_DIRECT_SIZES = (1, 23, 35, 50, 64)
GENERAL_BATCHES = (1, 16, 4096, 4097)
# relative to the scale, as BOUND: a few ulps of each type
GENERAL_BOUND = {torch.float32: 2e-5, torch.float64: 1e-12}
ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "myosuite_mjx_tpu_torch", "assets")


def _spd(n: int, batch: int, seed: int, dtype=np.float32):
  rng = np.random.default_rng(seed)
  r = rng.normal(size=(batch, n, n))
  a = r @ r.transpose(0, 2, 1) / n + np.eye(n)
  return a.astype(dtype), rng.normal(size=(batch, n)).astype(dtype)


def _spd_on_card(n: int, batch: int, seed: int, dtype):
  """As ``_spd``, made on the card (the large general batches)."""
  g = torch.Generator(device="cuda").manual_seed(seed)
  r = torch.randn(batch, n, n, generator=g, dtype=torch.float64,
                  device="cuda")
  a = r @ r.transpose(1, 2) / n + torch.eye(n, dtype=torch.float64,
                                            device="cuda")
  b = torch.randn(batch, n, generator=g, dtype=torch.float64, device="cuda")
  return a.to(dtype), b.to(dtype)


def _check_against_plain(ac: torch.Tensor, bc: torch.Tensor,
                         counter=cuda_linalg.spd_solve_cuda,
                         bound: float = BOUND,
                         fn=cuda_linalg.spd_solve_cuda):
  """Both calls of ``fn`` (with and without the factor) launch
  ``counter``'s kernel once each and agree with the plain version."""
  counters = (cuda_linalg.spd_solve_cuda, cuda_linalg.spd_solve_general_cuda)
  before = [c.launches for c in counters]
  x, L = fn(ac, bc, factor=True)
  x_only = fn(ac, bc)
  xp, Lp = linalg.spd_solve_plain(ac, bc, factor=True)
  torch.cuda.synchronize()
  assert [c.launches - n for c, n in zip(counters, before)] == [
      2 if c is counter else 0 for c in counters]
  assert torch.equal(x, x_only)
  np.testing.assert_allclose(x.cpu().numpy(), xp.cpu().numpy(), rtol=0,
                             atol=bound * float(xp.abs().max()))
  np.testing.assert_allclose(L.cpu().numpy(), Lp.cpu().numpy(), rtol=0,
                             atol=bound * float(Lp.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("n", SIZES)
def test_kernel_matches_plain_on_card(n, batch):
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the kernel has no CPU mode")
  a, b = _spd(n, batch, seed=n * 10_000 + batch)
  _check_against_plain(torch.as_tensor(a, device="cuda"),
                       torch.as_tensor(b, device="cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [23, 24])
def test_kernel_on_misaligned_view(n):
  """A contiguous view 4 bytes past a 16-byte boundary takes the plain load."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the kernel has no CPU mode")
  batch = 4096
  a, b = _spd(n, batch, seed=n)
  big = torch.empty(batch * n * n + 1, device="cuda")
  ac = big[1:].view(batch, n, n)
  ac.copy_(torch.as_tensor(a))
  assert ac.is_contiguous() and ac.data_ptr() % 16 == 4
  _check_against_plain(ac, torch.as_tensor(b, device="cuda"))


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take():
  """Float64 and n > 64 are taken since the general kernel came; other
  types, mixed types, non-contiguous inputs, mixed devices and n = 0 are
  not."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  a, b = _spd(5, 3, seed=0)
  ac = torch.as_tensor(a, device="cuda")
  bc = torch.as_tensor(b, device="cuda")
  with pytest.raises(TypeError):
    cuda_linalg.spd_solve_cuda(ac.half(), bc.half())
  with pytest.raises(TypeError):
    cuda_linalg.spd_solve_cuda(ac, bc.double())
  with pytest.raises(ValueError):
    cuda_linalg.spd_solve_cuda(ac.transpose(1, 2), bc)
  with pytest.raises(ValueError):
    cuda_linalg.spd_solve_cuda(ac, bc.cpu())
  with pytest.raises(ValueError):
    cuda_linalg.spd_solve_cuda(torch.zeros(2, 0, 0, device="cuda"),
                               torch.zeros(2, 0, device="cuda"))
  for fn in (cuda_linalg.spd_solve_cuda, cuda_linalg.spd_solve_general_cuda):
    assert fn(ac.double(), bc.double()).dtype == torch.float64
    x = fn(torch.eye(65, device="cuda").expand(2, 65, 65).contiguous(),
           torch.ones(2, 65, device="cuda"))
    torch.cuda.synchronize()
    assert torch.equal(x, torch.ones(2, 65, device="cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("batch", GENERAL_BATCHES)
@pytest.mark.parametrize("dtype, n", [
    *((torch.float64, n) for n in GENERAL_F64_SIZES),
    *((torch.float32, n) for n in GENERAL_F32_SIZES)],
                         ids=lambda v: str(v).replace("torch.", ""))
def test_general_kernel_matches_plain_on_card(dtype, n, batch):
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the kernel has no CPU mode")
  a, b = _spd_on_card(n, batch, n * 10_000 + batch + 7, dtype)
  _check_against_plain(a, b, cuda_linalg.spd_solve_general_cuda,
                       GENERAL_BOUND[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("batch", GENERAL_BATCHES)
@pytest.mark.parametrize("n", GENERAL_F32_DIRECT_SIZES)
def test_general_kernel_float32_direct_on_card(n, batch):
  """Float32 with n <= 64 through spd_solve_general_cuda itself (the
  dispatch sends it to the register kernel): the shared-tile route."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the kernel has no CPU mode")
  a, b = _spd_on_card(n, batch, n * 10_000 + batch + 9, torch.float32)
  _check_against_plain(a, b, cuda_linalg.spd_solve_general_cuda,
                       GENERAL_BOUND[torch.float32],
                       cuda_linalg.spd_solve_general_cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, n", [
    (torch.float64, 23), (torch.float64, 24), (torch.float64, 64),
    (torch.float64, 72), (torch.float32, 72)],
                         ids=lambda v: str(v).replace("torch.", ""))
def test_general_kernel_on_misaligned_view(dtype, n):
  """A contiguous view one element past a 16-byte boundary: the register
  route's plain loads (no bulk copy), the shared tile's cp.async."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the kernel has no CPU mode")
  batch = 4096
  a, b = _spd_on_card(n, batch, n + 3, dtype)
  big = torch.empty(batch * n * n + 1, dtype=dtype, device="cuda")
  ac = big[1:].view(batch, n, n)
  ac.copy_(a)
  assert ac.is_contiguous() and ac.data_ptr() % 16 != 0
  _check_against_plain(ac, b, cuda_linalg.spd_solve_general_cuda,
                       GENERAL_BOUND[dtype])


def clamp_systems(n: int, dtype, seed: int = 0):
  """Systems whose factor meets the clamp: an SPD background with a
  decoupled block at p (first, middle, last) that is (0) a zero row and
  column, a pivot of exactly 0; (1) the same with a diagonal of -2^-20, a
  pivot below tiny; (2) [[4, 2], [2, 1]], rank-deficient PSD, a pivot that
  reaches 0; (3) [[4, 2], [2, 1 - 2^-20]], slightly indefinite, a pivot
  that reaches -2^-20. Every operation on the blocks is exact, so every
  version meets the same pivots; x is finite in (1) and (3), NaN or
  infinite in (0) and (2). Returns numpy a, b and, per system, the clamped
  pivot's index and a_jj there."""
  rng = np.random.default_rng(seed)
  blocks = ([[0.0]], [[-2.0 ** -20]], [[4.0, 2.0], [2.0, 1.0]],
            [[4.0, 2.0], [2.0, 1.0 - 2.0 ** -20]])
  mats, piv = [], []
  for kind, blk in enumerate(blocks):
    size = len(blk)
    for p in sorted({0, (n - size) // 2, n - size}) if n >= size else ():
      r = rng.normal(size=(n, n))
      a = r @ r.T / n + np.eye(n)
      a[p:p + size, :] = 0.0
      a[:, p:p + size] = 0.0
      a[p:p + size, p:p + size] = blk
      mats.append(a)
      piv.append((p + size - 1, 0.0 if kind in (0, 2) else -2.0 ** -20))
  b = rng.normal(size=(len(mats), n))
  return np.stack(mats).astype(dtype), b.astype(dtype), piv


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, n", [
    *((torch.float64, n) for n in (1, 2, 8, 9, 23, 24, 64, 65, 72, 169)),
    *((torch.float32, n) for n in (2, 35, 65, 72, 241))],
                         ids=lambda v: str(v).replace("torch.", ""))
def test_general_kernel_clamp_cases(dtype, n):
  """The pivot clamp at finfo(dtype).tiny with L_jj = a_jj / sqrt(tiny):
  x NaN and infinite where the plain version's is, and close elsewhere
  (each system at its own scale); x equal with and without the factor."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the kernel has no CPU mode")
  np_dtype = np.float64 if dtype == torch.float64 else np.float32
  a, b, _ = clamp_systems(n, np_dtype, seed=n)
  a, b = torch.as_tensor(a, device="cuda"), torch.as_tensor(b, device="cuda")
  x, L = cuda_linalg.spd_solve_general_cuda(a, b, factor=True)
  x_only = cuda_linalg.spd_solve_general_cuda(a, b)
  xp, Lp = linalg.spd_solve_plain(a, b, factor=True)
  torch.cuda.synchronize()
  assert torch.equal(x.nan_to_num(), x_only.nan_to_num())
  assert torch.equal(x.isnan(), x_only.isnan())
  bound = GENERAL_BOUND[dtype]
  for k, p in ((x, xp), (L, Lp)):
    k, p = k.cpu().numpy(), p.cpu().numpy()
    np.testing.assert_array_equal(np.isnan(k), np.isnan(p))
    np.testing.assert_array_equal(np.isposinf(k), np.isposinf(p))
    np.testing.assert_array_equal(np.isneginf(k), np.isneginf(p))
    for s in range(len(p)):
      fin = np.isfinite(p[s])
      if fin.any():
        np.testing.assert_allclose(k[s][fin], p[s][fin], rtol=0,
                                   atol=bound * np.abs(p[s][fin]).max())


@pytest.mark.gpu
def test_general_kernel_shared_memory_limit():
  """The sizes above straddle the limit the kernel reads from the card."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  n64 = cuda_linalg.general_max_shared_n(torch.float64)
  n32 = cuda_linalg.general_max_shared_n(torch.float32)
  assert n64 in GENERAL_F64_SIZES and n64 + 1 in GENERAL_F64_SIZES
  assert n32 in GENERAL_F32_SIZES and n32 + 1 in GENERAL_F32_SIZES


@pytest.mark.gpu
def test_float64_env_runs_through_the_general_kernel():
  """MyoEnv in float64 on the card (the repaired fault): hand23's pose
  task, 4 envs, 3 control steps, against the same on the CPU. Float64 on
  both sides in another operation order; contact rows amplify it."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  actions = np.random.default_rng(0).uniform(0, 1, (3, 4, 39))
  out = {}
  before = cuda_linalg.spd_solve_general_cuda.launches
  for device in ("cuda", "cpu"):
    benv = BatchedEnv(PoseEnv(os.path.join(ASSETS, "hand23.npz"),
                              dtype=torch.float64, **HAND_POSE_FIXED), 4,
                      device)
    st = benv.init()
    for a in actions:
      st = benv.step(st, torch.as_tensor(a, device=device))
    out[device] = st
  torch.cuda.synchronize()
  assert cuda_linalg.spd_solve_general_cuda.launches > before
  for f in ("qpos", "qvel", "act"):
    np.testing.assert_allclose(
        getattr(out["cuda"].data, f).cpu().numpy(),
        getattr(out["cpu"].data, f).numpy(), rtol=0, atol=1e-6, err_msg=f)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_chain72_physics_runs_through_the_general_kernel(dtype):
  """Physics on chain72 (every solve 72 x 72) on the card, 10 substeps of
  8 envs, against float64 on the CPU: float32 within the free-joint
  scene's card bound (qpos 1e-4), float64 within 1e-8."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  path = os.path.join(ASSETS, "chain72.npz")
  qvel = np.random.default_rng(1).normal(scale=0.05, size=(8, 72))
  res = {}
  before = cuda_linalg.spd_solve_general_cuda.launches
  for device, dt in (("cuda", dtype), ("cpu", torch.float64)):
    phys = api.load(path, dt, device)
    d = phys.make_data(8)
    d = d.replace(qvel=torch.as_tensor(qvel, dtype=dt, device=device))
    res[device] = phys.step_n(10)(d)
  torch.cuda.synchronize()
  assert cuda_linalg.spd_solve_general_cuda.launches > before
  bound = 1e-4 if dtype == torch.float32 else 1e-8
  np.testing.assert_allclose(res["cuda"].qpos.double().cpu().numpy(),
                             res["cpu"].qpos.numpy(), rtol=0, atol=bound)


def _hand23_pose(dtype):
  return PoseEnv(os.path.join(ASSETS, "hand23.npz"), dtype=dtype,
                 **HAND_POSE_FIXED)


def _legs80_walk(dtype):
  from myosuite_mjx_tpu_torch import envs
  return envs.make("legs80Walk-v0", dtype=dtype,
                   model_path=os.path.join(ASSETS, "legs80_knee.npz"))


# scene: (env, its rows and nv, the equality rows)
GRAPH_SCENES = {"hand23": (_hand23_pose, (119, 23), 0),
                "legs80": (_legs80_walk, (138, 34), 14)}


@pytest.mark.gpu
@pytest.mark.parametrize("scene", sorted(GRAPH_SCENES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_newton_graph_replay_matches_eager_on_card(dtype, scene,
                                                   monkeypatch):
  """The Newton solves of two control steps at B 4096 on the card, of
  hand23 pose ([4096, 119, 23]) and of legs80 walk on MyoLeg's knees
  (``legs80_knee``, [4096, 138, 34]: the knees' 14 equality rows, the
  feet's contacts on the floor, and each
  step's reset solving its own), each run eagerly and through the graph
  path (``route`` forced: these shapes take the fused kernel, the graph
  path nv > 64) from an empty cache (the warm-up on the side stream, the
  capture, then replays): qacc, force and per-env iterations bit for bit, the same
  host syncs, the same SPD launches counted (float32 in the register
  kernel's counter, float64 in the general kernel's), and returned
  tensors that are not the graph's static buffers. On legs80 the
  equality and contact rows hold force."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  from myosuite_mjx_tpu_torch.engine import graphs, solver
  make_env, shape, n_eq = GRAPH_SCENES[scene]
  batch = 4096
  solves = []
  inner = solver._newton_solve

  def recorded(*args):
    solves.append(args)
    return inner(*args)

  benv = BatchedEnv(make_env(dtype), batch, "cuda")
  g = torch.Generator(device="cuda").manual_seed(0)
  st = benv.init()
  with monkeypatch.context() as mp:
    mp.setattr(solver, "_newton_solve", recorded)
    for _ in range(2):
      a = torch.rand((batch, benv.env.action_dim), generator=g,
                     device="cuda", dtype=dtype) * 2 - 1
      st = benv.step(st, a)
  assert len(solves) >= 3 and solves[0][2].shape == (batch,) + shape

  def run(args, graph: bool):
    before = [c.launches for c in graphs.COUNTERS]
    syncs = solver.newton_host_syncs.count
    with monkeypatch.context() as mp:
      # hand23 and legs80 take the fused kernel; the graph path serves
      # nv > 64 and is held here on these solves
      mp.setattr(solver, "route",
                 lambda *a: solver.STAGED if graph else solver.EAGER)
      out = solver._newton_solve(*args)
    torch.cuda.synchronize()
    return (out, [c.launches - b for c, b in zip(graphs.COUNTERS, before)],
            solver.newton_host_syncs.count - syncs)

  solver.staged.clear()
  worst = 0.0
  rows = torch.zeros(shape[0], dtype=torch.int64, device="cuda")
  for args in solves:
    eager, eager_launches, eager_syncs = run(args, graph=False)
    out, launches, syncs = run(args, graph=True)
    for a, b, what in zip(out, eager, ("qacc", "force", "iterations")):
      worst = max(worst, float((a.double() - b.double()).abs().max()))
      assert torch.equal(a, b), what
    assert launches == eager_launches and sum(launches) > 0
    assert syncs == eager_syncs
    rows += (eager[1] != 0).sum(0)
  if n_eq:
    # envs holding force on each equality row, and on the contact slots
    # (24 of 4 rows each, last)
    assert (rows[:n_eq] > 0).all() and rows[-96:].sum() > 0, rows
    print(f"{scene}: envs x solves with force on each equality row "
          f"{rows[:n_eq].tolist()}, on contact rows {int(rows[-96:].sum())}")
  (staged,) = solver.staged.entries.values()
  assert all(g is not None for g in staged.parts.graphs)
  for t in out:
    assert t.data_ptr() not in {s.data_ptr() for s in staged.carry}
  print(f"newton graph replay vs eager, {scene}, {dtype}, {len(solves)} "
        f"solves: largest difference {worst}")


def _state_leaves(x, path=""):
  """(path, tensor) of every tensor in a state, dataclasses and dicts
  walked."""
  if isinstance(x, torch.Tensor):
    yield path, x
  elif isinstance(x, dict):
    for k in sorted(x):
      yield from _state_leaves(x[k], f"{path}.{k}")
  elif dataclasses.is_dataclass(x):
    for f in dataclasses.fields(x):
      yield from _state_leaves(getattr(x, f.name), f"{path}.{f.name}")


@pytest.mark.gpu
@pytest.mark.parametrize("scene", sorted(GRAPH_SCENES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_forward_graph_replay_matches_eager_on_card(dtype, scene,
                                                    monkeypatch):
  """Three ``autoreset_step``s at B 4096 on the card, of hand23 pose and
  of legs80 walk on MyoLeg's knees, from one state, actions and seed,
  once through the forward's graphs from empty caches (warm-up, capture,
  replays) and once eagerly, Newton in the fused kernel both times: every
  state's
  every tensor (each Data field, the contact set and overlay, obs, reward,
  done, info, aux) bit for bit, the envs that reset and those that did not
  (a quarter of the clocks at the horizon), and the same SPD launches
  counted. No returned tensor shares memory with a graph's buffers."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  from myosuite_mjx_tpu_torch.engine import forward, graphs, solver
  make_env, _, _ = GRAPH_SCENES[scene]
  batch = 4096
  env = make_env(dtype)
  g = torch.Generator(device="cuda").manual_seed(0)
  actions = [torch.rand((batch, env.action_dim), generator=g, device="cuda",
                        dtype=dtype) * 2 - 1 for _ in range(3)]

  def run(graph: bool):
    forward.staged.clear()
    solver.staged.clear()
    before = [c.launches for c in graphs.COUNTERS]
    gen = torch.Generator(device="cuda").manual_seed(1)
    states = []
    with monkeypatch.context() as mp:
      if not graph:
        mp.setattr(graphs, "graphable", lambda tensors: False)
      st = env.reset(batch, "cuda", gen)
      steps = torch.arange(batch, device="cuda", dtype=torch.int32) % 4
      st = st.replace(steps=env.horizon - 1 - steps)
      for a in actions:
        st = env.autoreset_step(st, a, gen)
        states.append(st)
    torch.cuda.synchronize()
    return states, [c.launches - b for c, b in zip(graphs.COUNTERS, before)]

  eager, eager_launches = run(graph=False)
  assert not forward.staged.entries
  graphed, launches = run(graph=True)
  assert launches == eager_launches and sum(launches) > 0
  worst = 0.0
  for i, (a, b) in enumerate(zip(graphed, eager)):
    la, lb = dict(_state_leaves(a)), dict(_state_leaves(b))
    assert la.keys() == lb.keys()
    for k in lb:
      if la[k].is_floating_point():
        worst = max(worst, float((la[k].double() - lb[k].double()).abs()
                                 .max()) if la[k].numel() else 0.0)
      assert torch.equal(la[k], lb[k]), (i, k)
    kept = b.info["terminated"] | b.info["truncated"]
    assert kept.any() and not kept.all(), i
  # the first reset, asked for "cuda", and the steps, on "cuda:0", share
  # one model, so every key's graph A was captured
  stepped = env.device_model(graphed[-1].data.qpos.device)
  staged = list(forward.staged.entries.values())
  assert staged and all(st.m is stepped for st in staged)
  assert all(st.parts.graphs[0] is not None for st in staged)
  assert any(st.parts.graphs[1] is not None for st in staged)
  buffers = set()
  for st in staged:
    for _, t in _state_leaves({"in": st.inputs, "ov": st.overlay,
                               "after": st.after}):
      buffers.add(t.untyped_storage().data_ptr())
    blocks, info, efc = st.rows or (None, None, None)
    for _, t in _state_leaves({"blocks": blocks or {}, "info": info}):
      buffers.add(t.untyped_storage().data_ptr())
  for a in graphed:
    for k, t in _state_leaves(a):
      if t.numel():
        assert t.untyped_storage().data_ptr() not in buffers, k
  print(f"forward graph replay vs eager, {scene}, {dtype}, 3 autoreset "
        f"steps: largest difference {worst}, SPD launches {launches}")


@pytest.mark.gpu
def test_default_cuda_device_shares_the_indexed_device_model():
  """``"cuda"`` and ``"cuda:0"`` name one card, so an env gives one
  ``DeviceModel`` for both: a ``BatchedEnv`` on the default device resets
  and steps on one model."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  env = _hand23_pose(torch.float32)
  current = torch.device("cuda", torch.cuda.current_device())
  dm = env.device_model("cuda")
  assert env.device_model(current) is dm
  assert env.device_model(torch.device("cuda")) is dm
  assert dm.device == current


@pytest.mark.gpu
def test_reflex_update_on_card_matches_cpu():
  """``reflex_update`` on 1,024 seeded float32 inputs: card float32
  against CPU float64, flags equal, stimulations within 1e-5."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  from myosuite_mjx_tpu_torch.agents import reflex
  rng = np.random.default_rng(0)
  n = 1024
  cp = reflex.expand_params(rng.uniform(-0.5, 2.5, (n, 46)), torch.float32,
                            "cpu")
  flags = {f: torch.as_tensor(rng.random((n, 2)) < 0.5)
           for f in reflex.ReflexState.__dataclass_fields__}
  sens = {k: torch.as_tensor(rng.uniform(lo, hi, (n, 2)),
                             dtype=torch.float32)
          for k, (lo, hi) in dict(
              theta=(-0.4, 0.4), d_pos=(-1.0, 2.0), dtheta=(-2.0, 2.0),
              load_ipsi=(-0.1, 1.5), alpha=(0.8, 2.4), dalpha=(-3.0, 3.0),
              alpha_f=(1.2, 2.0), phi_hip=(2.0, 3.8), phi_knee=(1.6, 3.3),
              phi_ankle=(1.0, 2.2), dphi_knee=(-5.0, 5.0),
              F_RF=(-1.0, 0.2), F_VAS=(-1.0, 0.2), F_GAS=(-1.0, 0.2),
              F_SOL=(-1.0, 0.2)).items()}
  sens["contact_ipsi"] = sens["load_ipsi"] > 0.1
  sens["contact_contra"] = sens["contact_ipsi"].flip(-1)
  sens["load_contra"] = sens["load_ipsi"].flip(-1)
  res = {}
  for device, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
    new, stim = reflex.reflex_update(
        cp.to(device, dtype),
        reflex.ReflexState(**{k: v.to(device) for k, v in flags.items()}),
        {k: v.to(device) if v.dtype == torch.bool else v.to(device, dtype)
         for k, v in sens.items()})
    res[device] = new, stim.double().cpu()
  for f in flags:
    assert torch.equal(getattr(res["cuda"][0], f).cpu(),
                       getattr(res["cpu"][0], f)), f
  np.testing.assert_allclose(res["cuda"][1].numpy(), res["cpu"][1].numpy(),
                             rtol=0, atol=1e-5)


@pytest.mark.gpu
def test_gym_env_and_cnn_encoder_on_card_match_cpu():
  """``gym_make`` on hand23's pose id, 3 steps on the card (float32)
  against the CPU (float64) within phase 5's qpos bound on the obs; the
  CNN encoder, card float32 against CPU float64, within 1e-5 of the
  largest feature."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  from myosuite_mjx_tpu_torch.envs import gym_make, visual
  actions = np.random.default_rng(0).uniform(0.0, 1.0, (3, 39))
  obs = {}
  for device, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
    env = gym_make("hand23PoseFixed-v0", seed=0, device=device, dtype=dtype)
    env.reset()
    for a in actions:
      o, r, term, trunc, _ = env.step(a)
      assert np.isfinite(r) and isinstance(term, bool)
    obs[device] = o
  np.testing.assert_allclose(obs["cuda"], obs["cpu"], rtol=0, atol=1e-4)
  frames = torch.randint(0, 256, (16, 84, 84, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(0))
  enc = visual.FlaxCNNEncoder(device="cuda")
  with torch.no_grad():
    card = enc(frames.cuda()).double().cpu()
    ref = enc.to("cpu", torch.float64)(frames)
  assert float((card - ref).abs().max() / ref.abs().max()) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("algo", ["npg", "ppo"])
def test_sharded_step_on_nccl_matches_plain_step(algo):
  """One sharded step at world size 1 on NCCL against the plain step from
  the same seed: hand23's pose task, 16 envs, horizon 5, PPO 2 epochs of
  2 minibatches; the largest parameter difference within 1e-6 of the
  largest parameter change (one process computes what the plain learner
  does)."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card")
  import socket
  import torch.distributed as dist
  from myosuite_mjx_tpu_torch import envs
  from myosuite_mjx_tpu_torch.parallel import mesh as pmesh
  from myosuite_mjx_tpu_torch.tools.scaling_efficiency import flat_params
  from myosuite_mjx_tpu_torch.train import npg, ppo
  env = envs.make("hand23PoseFixed-v0", horizon=5)

  def learner():
    if algo == "npg":
      return npg.NPG(env, npg.NPGConfig(num_envs=16))
    return ppo.PPO(env, ppo.PPOConfig(num_envs=16, unroll_length=5,
                                      num_minibatches=2, update_epochs=2))

  with socket.socket() as sk:
    sk.bind(("127.0.0.1", 0))
    address = f"tcp://127.0.0.1:{sk.getsockname()[1]}"
  assert pmesh.init_distributed(address, 1, 0, device="cuda") is False
  try:
    assert dist.get_backend() == "nccl"
    out = []
    for sharded in (True, False):
      lr = learner()
      if sharded:
        lr = (pmesh.ShardedNPG if algo == "npg" else pmesh.ShardedPPO)(lr)
      g = torch.Generator(device="cuda").manual_seed(0)
      ts = lr.init(generator=g)
      before = flat_params(ts).clone()
      ts, m = lr.train_step(ts, g)
      out.append(flat_params(ts))
  finally:
    dist.destroy_process_group()
  change = float((out[1] - before).abs().max())
  assert change > 0
  assert float((out[0] - out[1]).abs().max()) <= 1e-6 * change

"""The capsule-hull kernel (``csrc/capsule_hull.cu``) and the narrowphase's
route to it.

On the CPU: the source carries its note, the reference's constants and the
wrapper's functions, and the wrapper refuses CPU tensors before it builds
anything. Without a card the rest skips: the kernel has no CPU mode. Imports
no jax, so it runs on the GPU machine too:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_capsule_hull_kernel.py

On the card the kernel is held to the plain ``_capsule_hull`` (the CPU and
grad path) run on the card, bit for bit, in float32 and float64: at
track29's capsule-mesh group ([4096 envs, 6 pairs] against the cube's 12
faces) on random poses about the cube and on the poses of two control
steps of Lift tracking; on capsules lying parallel to a face above it (a
flat distance profile: the distance is the gap and the point lies over the
segment), segments through the hull (the inside branch), zero-length
capsules, a prism's hull of 44 faces (more than a warp's lanes), hulls
of 1,404 and 2,644 faces, and per-env sizes (the ``geom_size`` overlay) as well as the expanded
static ones. The group in ``collision.narrowphase_all`` takes the kernel
(one launch, counted) with the same bits as the plain route; the wrapper
raises on what it does not take; repeated launches and a CUDA graph's
replay give the same bits; CUDA events time the kernel against the plain
path it replaces.
"""
from __future__ import annotations

import re
import types

import numpy as np
import pytest
import torch

from myosuite_mjx_tpu_torch.engine import collision
from myosuite_mjx_tpu_torch.ops import cuda_linalg
from myosuite_mjx_tpu_torch.utils import spans

BATCH = 4096
TASK = "track29CubesmallLift-v0"


def test_the_source_has_its_note_and_the_references_constants():
  with open(cuda_linalg.CAPSULE_SOURCE) as f:
    src = f.read()
  note = src.split("#include")[0]
  for words in ("Replaces no Pallas kernel", "_capsule_hull",
                "What bounds it", "3.35 TB/s", "One warp per (env, pair)",
                "IEEE division", "-fmad=false"):
    assert words in note, words
  assert "-fmad=false" in cuda_linalg.FLAGS[cuda_linalg.CAPSULE_SOURCE]
  # the search's trips and ratio, and the clamp, are the plain path's
  assert re.findall(r"constexpr int kTrips = (\d+);", src) == [
      str(collision._GOLDEN_TRIPS)]
  assert re.findall(r"constexpr double kGolden = ([0-9.e-]+);", src) == [
      repr(collision._GOLDEN)]
  assert re.findall(r"constexpr double kMinVal = ([0-9.e-]+);", src) == [
      repr(collision._MINVAL)]
  exported = set(re.findall(r'extern "C" int (\w+)\(', src))
  assert exported == set(cuda_linalg._SIGNATURES[cuda_linalg.CAPSULE_SOURCE])
  # the SPD kernel's roofline reads kernels by that name: not this one's
  assert "spd_solve_kernel" not in src
  assert re.search(r"__global__ void __launch_bounds__\([^)]*\)\s+"
                   r"capsule_hull_kernel\(", src)


def test_the_wrapper_refuses_cpu_tensors_before_building(monkeypatch):
  def refuse(source):
    raise AssertionError(f"built {source}")

  monkeypatch.setattr(cuda_linalg, "_load", refuse)
  x = torch.zeros((2, 3, 3))
  m = torch.eye(3).expand(2, 3, 3, 3)
  with pytest.raises(ValueError, match="CUDA"):
    cuda_linalg.capsule_hull_cuda(x, m, x, x, m, torch.zeros((12, 3, 3)),
                                  torch.zeros((12, 4)))


# ---- on the card ----


def _skip_without_card():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _rotations(rng, n: int) -> np.ndarray:
  q = rng.normal(size=(n, 4))
  q /= np.linalg.norm(q, axis=-1, keepdims=True)
  w, x, y, z = q.T
  return np.stack([
      np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                2 * (x * z + w * y)], -1),
      np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                2 * (y * z - w * x)], -1),
      np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                1 - 2 * (x * x + y * y)], -1)], -2)


_groups: dict = {}


def _track29(dtype):
  """(env, the card's DeviceModel, its capsule-mesh group)."""
  if dtype not in _groups:
    from myosuite_mjx_tpu_torch import envs
    env = envs.make(TASK, dtype=dtype)
    m = env.device_model("cuda")
    (g,) = [g for g in collision.collision_spec(m).groups
            if g.span == spans.GROUP + "CAPSULE-MESH"]
    _groups[dtype] = (env, m, g)
  return _groups[dtype]


def _prism_hull(sides: int, dtype, radius=0.03, half=0.02):
  """The hull of a prism over a regular ``sides``-gon: 4 sides - 4 faces,
  built as the model's hulls are (``collision.hull_geometry``)."""
  ang = 2 * np.pi * np.arange(sides) / sides
  ring = np.stack([radius * np.cos(ang), radius * np.sin(ang)], -1)
  verts = np.concatenate([np.c_[ring, np.full(sides, -half)],
                          np.c_[ring, np.full(sides, half)]])
  tris = []
  for k in range(1, sides - 1):
    tris.append([0, k, k + 1])
    tris.append([sides, sides + k + 1, sides + k])
  for k in range(sides):
    j = (k + 1) % sides
    tris.append([k, j, sides + j])
    tris.append([k, sides + j, sides + k])
  tris = verts[np.asarray(tris)]
  host = types.SimpleNamespace(mesh_hull_tris=[tris], mesh_hull_verts=[verts])
  t, e = collision.hull_geometry(host, 0)
  as_t = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")
  return collision._Hull(tris=as_t(t), eqs=as_t(e), verts=as_t(verts))


def _poses(rng, batch: int, pairs: int, dtype, reach=0.06):
  """Capsule and hull frames [batch, pairs]: hulls about the origin, the
  capsules' centres within ``reach`` of them on each axis (apart,
  touching and inside)."""
  n = batch * pairs
  p2 = rng.uniform(-0.05, 0.05, (n, 3))
  p1 = p2 + rng.uniform(-reach, reach, (n, 3))
  m1, m2 = _rotations(rng, n), _rotations(rng, n)
  as_t = lambda a, *s: torch.as_tensor(a, dtype=dtype, device="cuda").reshape(
      batch, pairs, *s)
  return as_t(p1, 3), as_t(m1, 3, 3), as_t(p2, 3), as_t(m2, 3, 3)


def _plain(p1, m1, s1, p2, m2, hull):
  return collision._one(collision._capsule_hull)(
      p1, m1, s1[..., 0], s1[..., 1], p2, m2, hull.tris, hull.eqs)


def _kernel(p1, m1, s1, p2, m2, hull):
  return cuda_linalg.capsule_hull_cuda(p1, m1, s1, p2, m2, hull.tris,
                                       hull.eqs)


def _same_bits(kernel, plain, what: str) -> None:
  """Both routes' (dist, pos, n), bit for bit; prints the share of lanes
  that differ and the largest gap of each, for the record."""
  report = {}
  for name, a, b in zip(("dist", "pos", "n"), kernel, plain):
    assert a.shape == b.shape and a.dtype == b.dtype, (what, name)
    differ = (a != b).reshape(a.shape[0], a.shape[1], -1).any(-1)
    report[name] = (float(differ.double().mean()),
                    float((a.double() - b.double()).abs().max()))
  print(f"{what}: lanes that differ, largest gap {report}")
  for name, a, b in zip(("dist", "pos", "n"), kernel, plain):
    assert torch.equal(a, b), (what, name, report[name])


DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                                 ids=["float32", "float64"])


@pytest.mark.gpu
@DTYPES
def test_kernel_matches_plain_at_track29_group_shape_on_random_poses(dtype):
  _skip_without_card()
  _, _, g = _track29(dtype)
  assert tuple(g.hull.tris.shape) == (12, 3, 3) and g.size1.shape[0] == 6
  rng = np.random.default_rng(0)
  p1, m1, p2, m2 = _poses(rng, BATCH, 6, dtype)
  s1 = g.size1.expand(BATCH, -1, -1)
  launches = cuda_linalg.capsule_hull_cuda.launches
  kernel = _kernel(p1, m1, s1, p2, m2, g.hull)
  assert cuda_linalg.capsule_hull_cuda.launches == launches + 1
  plain = _plain(p1, m1, s1, p2, m2, g.hull)
  torch.cuda.synchronize()
  _same_bits(kernel, plain, f"track29 group, random poses, {dtype}")
  dist = kernel[0]
  # apart, touching and inside all present
  assert (dist > 0).any() and (dist < 0).any()
  assert bool((dist < -g.size1[:, 0].reshape(1, 6, 1)).any())


@pytest.mark.gpu
@DTYPES
def test_kernel_matches_plain_on_lift_tracking_poses(dtype):
  """The group's inputs from two control steps of Lift tracking at B 4096
  (the palm and fingertips over the cube at rest on its table)."""
  _skip_without_card()
  from myosuite_mjx_tpu_torch.envs.base import BatchedEnv
  env, m, g = _track29(dtype)
  benv = BatchedEnv(env, BATCH, "cuda", seed=0)
  gen = torch.Generator(device="cuda").manual_seed(0)
  st = benv.init()
  for _ in range(2):
    st = benv.step(st, torch.rand((BATCH, env.action_dim), generator=gen,
                                  device="cuda", dtype=dtype) * 2 - 1)
    d = st.data
    args = (d.geom_xpos[:, g.g1], d.geom_xmat[:, g.g1],
            g.size1.expand(BATCH, -1, -1), d.geom_xpos[:, g.g2],
            d.geom_xmat[:, g.g2])
    kernel = _kernel(*args, g.hull)
    plain = _plain(*args, g.hull)
    torch.cuda.synchronize()
    _same_bits(kernel, plain, f"track29 Lift poses, {dtype}")


@pytest.mark.gpu
@DTYPES
def test_capsule_parallel_to_a_face(dtype):
  """A capsule lying along the cube's top face, a gap above it: every
  point of the segment is as far from the hull, so the search's profile is
  flat. The distance is the gap and the contact point lies over the
  segment, midway across the gap; both routes give the same bits."""
  _skip_without_card()
  _, _, g = _track29(dtype)
  rng = np.random.default_rng(1)
  n = 1024
  # the top face's height in the cube's frame, as the hull stores it
  half_cube = float(g.hull.tris[..., 2].max())
  assert abs(half_cube - 0.025) < 1e-8
  r = rng.uniform(0.005, 0.01, n)
  half = rng.uniform(0.002, 0.02, n)
  gap = rng.uniform(1e-4, 5e-3, n)
  # in the cube's frame: the axis along local x or y, the centre over the
  # face, so the whole segment lies over it
  use_x = rng.random(n) < 0.5
  axis = np.where(use_x[:, None], [[1.0, 0, 0]], [[0, 1.0, 0]])
  perp = np.where(use_x[:, None], [[0, 1.0, 0]], [[1.0, 0, 0]])
  along = rng.uniform(-1, 1, n) * (half_cube - half)
  across = rng.uniform(-0.02, 0.02, n)
  c_local = along[:, None] * axis + across[:, None] * perp
  c_local[:, 2] = half_cube + r + gap
  # the capsule's frame: its z (the axis) along ``axis``
  x = np.cross(axis, [[0, 0, 1.0]])
  frame1 = np.stack([x, np.cross(axis, x), axis], -1)
  m2 = _rotations(rng, n)
  p2 = rng.uniform(-0.05, 0.05, (n, 3))
  p1 = p2 + np.einsum("nij,nj->ni", m2, c_local)
  m1 = m2 @ frame1
  as_t = lambda a, *s: torch.as_tensor(a, dtype=dtype, device="cuda").reshape(
      n, 1, *s)
  s1 = as_t(np.c_[r, half, np.zeros(n)], 3)
  args = (as_t(p1, 3), as_t(m1, 3, 3), s1, as_t(p2, 3), as_t(m2, 3, 3))
  kernel = _kernel(*args, g.hull)
  plain = _plain(*args, g.hull)
  torch.cuda.synchronize()
  _same_bits(kernel, plain, f"parallel to a face, {dtype}")
  eps = 1e-5 if dtype == torch.float32 else 1e-12
  dist = kernel[0].double().cpu().numpy().reshape(n)
  assert np.abs(dist - gap).max() < eps
  pos_l = np.einsum("nji,nj->ni", m2,
                    kernel[1].double().cpu().numpy().reshape(n, 3) - p2)
  assert np.abs(pos_l[:, 2] - (half_cube + 0.5 * gap)).max() < eps
  seg = np.einsum("ni,ni->n", pos_l - c_local, axis)
  assert (np.abs(seg) <= half + eps).all()


@pytest.mark.gpu
@DTYPES
def test_segments_through_the_hull_and_zero_length_capsules(dtype):
  """Capsules centred in the cube and longer than it (the search's
  minimum lies inside: the least deep face's branch), and capsules of no
  length (a sphere)."""
  _skip_without_card()
  _, _, g = _track29(dtype)
  rng = np.random.default_rng(2)
  p1, m1, p2, m2 = _poses(rng, BATCH, 6, dtype)
  inner = p2 + torch.as_tensor(rng.uniform(-0.01, 0.01, (BATCH, 6, 3)),
                               dtype=dtype, device="cuda")
  long = torch.stack([torch.full((BATCH, 6), 0.008),
                      torch.full((BATCH, 6), 0.05),
                      torch.zeros((BATCH, 6))], -1).to(dtype).cuda()
  kernel = _kernel(inner, m1, long, p2, m2, g.hull)
  plain = _plain(inner, m1, long, p2, m2, g.hull)
  torch.cuda.synchronize()
  _same_bits(kernel, plain, f"through the hull, {dtype}")
  assert bool((kernel[0] < -0.008).all())
  point = g.size1.expand(BATCH, -1, -1).clone()
  point[..., 1] = 0.0
  kernel = _kernel(p1, m1, point, p2, m2, g.hull)
  plain = _plain(p1, m1, point, p2, m2, g.hull)
  torch.cuda.synchronize()
  _same_bits(kernel, plain, f"zero length, {dtype}")


@pytest.mark.gpu
@DTYPES
@pytest.mark.parametrize("sides,batch", [(12, BATCH), (352, 16), (662, 16)],
                         ids=["44-faces", "1404-faces", "2644-faces"])
def test_hulls_of_more_faces(dtype, sides, batch):
  """A prism's hull of 44 faces (more than a warp's lanes), and of 1,404
  and 2,644 faces (far more than a block's shared memory would hold: the
  kernel reads every hull through the read-only cache, so no F has a path
  of its own)."""
  _skip_without_card()
  hull = _prism_hull(sides, dtype)
  F = hull.tris.shape[0]
  assert F == 4 * sides - 4
  rng = np.random.default_rng(3)
  p1, m1, p2, m2 = _poses(rng, batch, 2, dtype)
  s1 = torch.as_tensor([[0.008, 0.02, 0.0], [0.005, 0.0, 0.0]], dtype=dtype,
                       device="cuda").expand(batch, -1, -1)
  kernel = _kernel(p1, m1, s1, p2, m2, hull)
  plain = _plain(p1, m1, s1, p2, m2, hull)
  torch.cuda.synchronize()
  _same_bits(kernel, plain, f"{F} faces, {dtype}")


@pytest.mark.gpu
@DTYPES
def test_per_env_sizes_and_the_expanded_static_ones(dtype):
  """The sizes as the ``geom_size`` overlay gives them ([B, G, 3], one a
  env) and as the static table expanded over the batch (stride 0): the
  same values give the same bits either way."""
  _skip_without_card()
  _, _, g = _track29(dtype)
  rng = np.random.default_rng(4)
  p1, m1, p2, m2 = _poses(rng, BATCH, 6, dtype)
  overlay = torch.as_tensor(
      np.stack([rng.uniform(0.004, 0.02, (BATCH, 6)),
                rng.uniform(0.0, 0.03, (BATCH, 6)),
                np.zeros((BATCH, 6))], -1), dtype=dtype, device="cuda")
  kernel = _kernel(p1, m1, overlay, p2, m2, g.hull)
  plain = _plain(p1, m1, overlay, p2, m2, g.hull)
  torch.cuda.synchronize()
  _same_bits(kernel, plain, f"per-env sizes, {dtype}")
  static = g.size1.expand(BATCH, -1, -1)
  assert static.stride(0) == 0
  _same_bits(_kernel(p1, m1, static, p2, m2, g.hull),
             _kernel(p1, m1, static.contiguous(), p2, m2, g.hull),
             f"expanded against contiguous sizes, {dtype}")


@pytest.mark.gpu
def test_narrowphase_takes_the_kernel_with_the_plain_routes_bits(monkeypatch):
  """track29's whole narrowphase on the card: the capsule-mesh group in
  one launch, counted, and every slot equal to the plain route's; the
  group counter counts it while a profiler records."""
  _skip_without_card()
  from torch.profiler import ProfilerActivity, profile
  env, m, g = _track29(torch.float32)
  st = env.reset(BATCH, "cuda")
  spec = collision.collision_spec(m)
  launches = cuda_linalg.capsule_hull_cuda.launches
  with profile(activities=[ProfilerActivity.CPU]):
    fused = collision.narrowphase_all(m, st.data, spec)
    assert spans.capsule_hull_fused_groups() == (1, 1)
  assert cuda_linalg.capsule_hull_cuda.launches == launches + 1
  monkeypatch.setattr(collision, "capsule_hull_on_kernel", lambda t: False)
  plain = collision.narrowphase_all(m, st.data, spec)
  assert cuda_linalg.capsule_hull_cuda.launches == launches + 1
  torch.cuda.synchronize()
  for a, b in zip(fused, plain):
    assert torch.equal(a, b)


@pytest.mark.gpu
def test_the_wrapper_refuses_what_it_does_not_take():
  _skip_without_card()
  _, _, g = _track29(torch.float32)
  rng = np.random.default_rng(5)
  p1, m1, p2, m2 = _poses(rng, 4, 6, torch.float32)
  s1 = g.size1.expand(4, -1, -1)
  tris, eqs = g.hull.tris, g.hull.eqs
  with pytest.raises(ValueError, match="CUDA"):
    cuda_linalg.capsule_hull_cuda(p1.cpu(), m1, s1, p2, m2, tris, eqs)
  with pytest.raises(TypeError, match="float32 or float64"):
    cuda_linalg.capsule_hull_cuda(*(t.half() for t in (p1, m1, s1, p2, m2,
                                                       tris, eqs)))
  with pytest.raises(TypeError, match="float32 or float64"):
    cuda_linalg.capsule_hull_cuda(p1.double(), m1, s1, p2, m2, tris, eqs)
  with pytest.raises(ValueError, match=r"\[\.\.\., 3, 3\]"):
    cuda_linalg.capsule_hull_cuda(p1, m1[..., 0], s1, p2, m2, tris, eqs)
  with pytest.raises(ValueError, match="F >= 1"):
    cuda_linalg.capsule_hull_cuda(p1, m1, s1, p2, m2, tris[:0], eqs[:0])
  with pytest.raises(ValueError, match="grad"):
    cuda_linalg.capsule_hull_cuda(p1.detach().clone().requires_grad_(), m1,
                                  s1, p2, m2, tris, eqs)


@pytest.mark.gpu
def test_repeated_launches_and_a_graph_replay_give_the_same_bits():
  _skip_without_card()
  _, _, g = _track29(torch.float32)
  rng = np.random.default_rng(6)
  p1, m1, p2, m2 = _poses(rng, BATCH, 6, torch.float32)
  s1 = g.size1.expand(BATCH, -1, -1)
  first = _kernel(p1, m1, s1, p2, m2, g.hull)
  again = _kernel(p1, m1, s1, p2, m2, g.hull)
  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    _kernel(p1, m1, s1, p2, m2, g.hull)
  torch.cuda.current_stream().wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    captured = _kernel(p1, m1, s1, p2, m2, g.hull)
  graph.replay()
  torch.cuda.synchronize()
  for a, b, c in zip(first, again, captured):
    assert torch.equal(a, b) and torch.equal(a, c)


def _time_ms(fn, reps: int) -> float:
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
  return start.elapsed_time(end) / reps


@pytest.mark.gpu
def test_kernel_time_against_the_plain_path():
  """CUDA events over 50 launches at track29's group in float32, beside
  the plain path's time on the same inputs (printed; the kernel must beat
  the plain path)."""
  _skip_without_card()
  _, _, g = _track29(torch.float32)
  rng = np.random.default_rng(7)
  p1, m1, p2, m2 = _poses(rng, BATCH, 6, torch.float32)
  s1 = g.size1.expand(BATCH, -1, -1)
  ms = _time_ms(lambda: _kernel(p1, m1, s1, p2, m2, g.hull), 50)
  plain_ms = _time_ms(lambda: _plain(p1, m1, s1, p2, m2, g.hull), 3)
  print(f"capsule_hull [{BATCH}, 6] F 12 float32 (CUDA events): kernel "
        f"{ms * 1e3:.1f} us a launch, plain {plain_ms:.3f} ms")
  assert ms < plain_ms

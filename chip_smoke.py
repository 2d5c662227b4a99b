#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit:

1. device: a CUDA card is required (no CPU fallback); prints the card's
   name and power limit as nvidia-smi reports them;
2. build: compiles the SPD-solve kernel (csrc/spd_solve.cu) from source;
3. kernel check: the kernel against its plain PyTorch version and against
   float64 ``torch.linalg.solve`` on random SPD batches and on M, M + h D
   and Newton H from a hand23 rollout; times kernel and plain version at
   the main path's shape [4096, 23];
4. main path: ``PoseEnv`` on the synthetic hand23 scene with the
   myoHandPoseFixed-v0 task, ``BatchedEnv`` of 4096 envs, ``init`` and 105
   control steps, so every env crosses horizon 100 once; checks finite
   outputs, the autoreset, the kernel launch count and the precision pin;
5. card against CPU: 5 control steps of the same 16 envs on the card
   (float32, kernel) and on the CPU (float64, plain version).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

DEVICE = "cuda"
B_MAIN = 4096
STEPS = 105
WARMUP = 2
HAND23 = os.path.join(ROOT, "myosuite_mjx_tpu_torch", "assets", "hand23.npz")
# kernel vs plain, float32 both: relative to the largest |x|. Random SPD
# batches have eigenvalues >= 1, so a few ulps of float32 suffice.
RANDOM_BOUND = 2e-5
# rollout matrices can be ill-conditioned (stiff contact rows): both
# solvers must be backward stable, |A x - b| <= bound * |A| |x| (inf-norms)
BACKWARD_BOUND = 1e-5
# card float32 vs CPU float64 after 5 control steps (50 contact-rich
# substeps). Float32 against float64 on the CPU gave 3.6e-6 (qpos),
# 8.4e-4 (qvel, of 6.8 peak) and 1.3e-7 (act); the bounds leave 25-80x.
CARD_CPU_BOUND = {"qpos": 1e-4, "qvel": 7e-2, "act": 1e-5}


def _say(*args):
  print(*args, flush=True)


def phase_device() -> str:
  if not torch.cuda.is_available():
    raise SystemExit("chip_smoke: no CUDA device visible; this run needs one")
  smi = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True, check=True,
      timeout=60).stdout.strip().splitlines()[0]
  _say(f"torch {torch.__version__} cuda {torch.version.cuda} "
       f"devices {torch.cuda.device_count()}")
  return smi


def phase_build():
  from myosuite_mjx_tpu_torch.ops import cuda_linalg
  path, seconds, log = cuda_linalg.build()
  regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
  _say(f"build: {seconds:.2f} s -> {os.path.relpath(path, ROOT)}; "
       f"{regs[0] if regs else 'already built'}")


def _time_ms(fn, reps: int = 50) -> float:
  for _ in range(5):
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


def _rollout_systems():
  """M, M + h D and Newton H (active contacts) from a hand23 rollout."""
  from myosuite_mjx_tpu_torch.engine import collision, constraint
  from myosuite_mjx_tpu_torch.envs.base import BatchedEnv
  from myosuite_mjx_tpu_torch.envs.pose import HAND_POSE_FIXED, PoseEnv
  env = PoseEnv(HAND23, **HAND_POSE_FIXED)
  benv = BatchedEnv(env, B_MAIN, DEVICE, seed=1)
  st = benv.init()
  g = torch.Generator(device=DEVICE).manual_seed(1)
  for _ in range(3):
    st = benv.step(st, torch.rand((B_MAIN, env.action_dim), generator=g,
                                  device=DEVICE))
  d, m = st.data, env.device_model(DEVICE)
  blocks, info = collision.contacts(m, d)
  J, aref, D, is_eq, _, _ = constraint.make_efc(m, d, blocks)
  jar = (J @ d.qacc[..., None])[..., 0] - aref
  w = D * (is_eq | (jar < 0))
  if not bool((w > 0).any()):
    raise AssertionError("no active constraint row in the rollout state")
  H = d.qM + (J.transpose(-1, -2) * w[:, None, :]) @ J
  mhd = d.qM + m.opt.timestep * torch.diag(m.dof_damping)
  return {"M": d.qM, "M+hD": mhd, "H": H}, d.qfrc_smooth


def phase_kernel_check() -> dict:
  from myosuite_mjx_tpu_torch.ops import cuda_linalg, linalg
  g = torch.Generator().manual_seed(0)
  worst_main = 0.0
  for n in (4, 23, 64):
    for batch in (1, 1000, 4096, 4097):
      r = torch.randn(batch, n, n, generator=g, dtype=torch.float64)
      a64 = r @ r.transpose(1, 2) / n + torch.eye(n, dtype=torch.float64)
      b64 = torch.randn(batch, n, generator=g, dtype=torch.float64)
      a, b = a64.float().cuda(), b64.float().cuda()
      x, L = cuda_linalg.spd_solve_cuda(a, b, factor=True)
      xp, Lp = linalg.spd_solve_plain(a, b, factor=True)
      ref = torch.linalg.solve(a64.cuda(), b64.cuda())
      torch.cuda.synchronize()
      scale = float(xp.abs().max())
      e_plain = float((x - xp).abs().max()) / scale
      e_l = float((L - Lp).abs().max()) / float(Lp.abs().max())
      e_ref = float((x.double() - ref).abs().max()) / float(ref.abs().max())
      ok = max(e_plain, e_l, e_ref) <= RANDOM_BOUND
      _say(f"kernel n={n} B={batch}: rel err vs plain {e_plain:.3e}, factor "
           f"{e_l:.3e}, vs float64 solve {e_ref:.3e} (bound {RANDOM_BOUND:g})"
           f" {'ok' if ok else 'FAIL'}")
      if not ok:
        raise AssertionError(f"kernel disagrees at n={n} B={batch}")
      if (n, batch) == (23, 4096):
        worst_main = max(worst_main, float((x - xp).abs().max()))

  systems, rhs = _rollout_systems()
  for name, a in systems.items():
    a = a.contiguous()
    x = cuda_linalg.spd_solve_cuda(a, rhs)
    xp = linalg.spd_solve_plain(a, rhs)
    ref = torch.linalg.solve(a.double(), rhs.double())
    torch.cuda.synchronize()

    def backward_err(sol):
      res = (a.double() @ sol.double()[..., None])[..., 0] - rhs.double()
      an = a.double().abs().sum(-1).amax(-1)
      return float((res.abs().amax(-1) / (an * sol.double().abs().amax(-1)
                                          + 1e-300)).max())

    be, bp = backward_err(x), backward_err(xp)
    cond = float(torch.linalg.cond(a.double()).max())
    e_ref = float(((x.double() - ref).abs().amax(-1)
                   / ref.abs().amax(-1).clamp_min(1e-300)).max())
    ok = max(be, bp) <= BACKWARD_BOUND
    _say(f"kernel on hand23 {name} [{a.shape[0]}, {a.shape[1]}]: backward "
         f"err kernel {be:.3e}, plain {bp:.3e} (bound {BACKWARD_BOUND:g}); "
         f"max cond {cond:.3e}; fwd rel err vs float64 {e_ref:.3e} "
         f"{'ok' if ok else 'FAIL'}")
    if not ok:
      raise AssertionError(f"kernel not backward stable on {name}")
    worst_main = max(worst_main, float((x - xp).abs().max()))

  r = torch.randn(B_MAIN, 23, 23, generator=g)
  a = (r @ r.transpose(1, 2) / 23 + torch.eye(23)).cuda()
  b = torch.randn(B_MAIN, 23, generator=g).cuda()
  times = {"plain": [], "kernel": []}
  for which in ("plain", "kernel", "kernel", "plain"):
    fn = (linalg.spd_solve_plain if which == "plain"
          else cuda_linalg.spd_solve_cuda)
    times[which].append(_time_ms(lambda: fn(a, b)))
  ms = float(np.mean(times["kernel"]))
  plain_ms = float(np.mean(times["plain"]))
  _say(f"spd_solve [4096, 23] float32: kernel {times['kernel']} ms, plain "
       f"{times['plain']} ms (CUDA events, 50 launches each)")
  return {"max_abs_err": worst_main, "ms": ms, "plain_ms": plain_ms}


def phase_main_path() -> dict:
  from myosuite_mjx_tpu_torch.engine import solver
  from myosuite_mjx_tpu_torch.envs import base
  from myosuite_mjx_tpu_torch.envs.pose import HAND_POSE_FIXED, PoseEnv
  from myosuite_mjx_tpu_torch.ops import cuda_linalg
  env = PoseEnv(HAND23, **HAND_POSE_FIXED)
  if not base.precision_pinned():
    raise AssertionError("float32 matmul precision is not pinned")
  g = torch.Generator(device=DEVICE).manual_seed(0)
  torch.cuda.synchronize()

  cuda_linalg.spd_solve_cuda.launches = 0
  solver.newton_host_syncs.count = 0
  benv = base.BatchedEnv(env, B_MAIN, DEVICE, seed=0)
  state = benv.init()
  restarted = torch.zeros(B_MAIN, dtype=torch.bool, device=DEVICE)
  restarts = torch.zeros((), dtype=torch.int64, device=DEVICE)
  t0 = None
  for i in range(STEPS):
    if i == WARMUP:
      torch.cuda.synchronize()
      syncs0 = solver.newton_host_syncs.count
      t0 = time.perf_counter()
    action = torch.rand((B_MAIN, env.action_dim), generator=g, device=DEVICE)
    state = benv.step(state, action)
    ended = state.info["terminated"] | state.info["truncated"]
    restarted |= ended
    restarts += ended.sum()
  torch.cuda.synchronize()
  seconds = time.perf_counter() - t0
  launches = cuda_linalg.spd_solve_cuda.launches
  syncs = solver.newton_host_syncs.count - syncs0

  for name, x in (("obs", state.obs), ("reward", state.reward),
                  ("qpos", state.data.qpos)):
    if not bool(torch.isfinite(x).all()):
      raise AssertionError(f"non-finite {name} after the rollout")
  restarts = int(restarts)
  if not bool(restarted.all()):
    raise AssertionError(f"{int((~restarted).sum())} envs never reset")
  if launches <= 0:
    raise AssertionError("the main path never launched the kernel")
  if not base.precision_pinned():
    raise AssertionError("float32 matmul precision lost its pin")
  timed = STEPS - WARMUP
  ctrl_rate = timed * B_MAIN / seconds
  _say(f"main path: hand23 PoseEnv B={B_MAIN}, {STEPS} control steps "
       f"(frame_skip {env.frame_skip}), autoreset {restarts} envs, "
       f"ne_active mean {float(state.data.ne_active.float().mean()):.2f}, "
       f"reward mean {float(state.reward.mean()):.4f}")
  _say(f"main path: spd_solve launches {launches}; Newton host syncs "
       f"{syncs / timed:.2f} per control step; {timed} timed steps in "
       f"{seconds:.3f} s: {ctrl_rate * env.frame_skip:.1f} physics-steps/s, "
       f"{ctrl_rate:.1f} control-steps/s")
  return {"launches": launches}


def phase_card_vs_cpu():
  from myosuite_mjx_tpu_torch.envs.base import BatchedEnv
  from myosuite_mjx_tpu_torch.envs.pose import HAND_POSE_FIXED, PoseEnv
  B = 16
  actions = np.random.default_rng(0).uniform(0.0, 1.0, (5, B, 39))
  out = {}
  for device, dtype in ((DEVICE, torch.float32), ("cpu", torch.float64)):
    benv = BatchedEnv(PoseEnv(HAND23, dtype=dtype, **HAND_POSE_FIXED), B,
                      device)
    st = benv.init()
    for a in actions:
      st = benv.step(st, torch.as_tensor(a, dtype=dtype, device=device))
    out[dtype] = st.data
  for f, bound in CARD_CPU_BOUND.items():
    card = getattr(out[torch.float32], f).double().cpu()
    cpu = getattr(out[torch.float64], f)
    err = float((card - cpu).abs().max())
    ok = err <= bound
    _say(f"card float32 vs cpu float64, {f}: max abs err {err:.3e} "
         f"(bound {bound:g}, peak |{f}| {float(cpu.abs().max()):.3f}) "
         f"{'ok' if ok else 'FAIL'}")
    if not ok:
      raise AssertionError(f"card and CPU disagree on {f}")


def main() -> int:
  smi = phase_device()
  phase_build()
  kernel = phase_kernel_check()
  main_path = phase_main_path()
  phase_card_vs_cpu()
  _say(smi)
  _say(json.dumps({"kernels": [{
      "name": "spd_solve", "route": "cuda",
      "source": "myosuite_mjx_tpu_torch/csrc/spd_solve.cu",
      "replaces": "myosuite_mjx_tpu/ops/pallas_linalg.py:77",
      "launches": main_path["launches"], **kernel}]}))
  _say(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())

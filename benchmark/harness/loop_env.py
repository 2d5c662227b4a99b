"""The closed loop of batched env steps: ``BatchedEnv.step`` of a task id,
one control step issued when the last has returned, as an RL loop does.

Traffic parameters (``benchmark/workloads/<traffic>.json``):

- ``task``, ``frame_skip``, ``horizon``: the program's task id and the
  step's sizes it must have;
- ``batch``: envs stepped together;
- ``action_pool``: batches of actions made in set-up, U(-1, 1) over the
  declared action space, one a control step (cycled if a window runs
  longer);
- ``warmup_steps``: control steps in set-up, through the same call;
- ``trace_steps``: control steps in the traced window of a ``--trace 1``
  run;
- ``check_steps``, ``check_block``: control steps whose every row the
  reference recomputes after the window (drawn from the seed), in blocks
  of rows;
- ``reference``: the reference task (``benchmark/reference/step.py``).

Episode clocks start staggered uniformly over the horizon, so about
1/horizon of the envs reset in every step. The rate counts whole control
steps x frame_skip x batch over the window's wall time, which ends in
``torch.cuda.synchronize()`` on the first whole step after ``--seconds``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import compare, device, precision, trace
from benchmark.reference import step as ref_step


def _snap(st) -> dict:
  """Copies of what the reference reads of a state and what it compares."""
  d = st.data
  out = {k: getattr(d, k).clone() for k in ref_step.STATE_KEYS}
  out.update({"aux." + k: v.clone() for k, v in st.aux.items()})
  out.update(steps=st.steps.clone(), obs=st.obs.clone(),
             reward=st.reward.clone(), done=st.done.clone(),
             truncated=st.info["truncated"].clone(),
             force_rows=((d.efc_force_limit != 0).sum(1)
                         + (d.contact_force != 0).sum(1)))
  return out


def _expect(env, tr: dict) -> None:
  for k in ("frame_skip", "horizon"):
    if getattr(env, k) != tr[k]:
      raise RuntimeError(f"task {tr['task']} has {k} {getattr(env, k)}, "
                         f"the traffic states {tr[k]}")


def run(ctx) -> dict:
  from myosuite_mjx_tpu_torch import envs
  from myosuite_mjx_tpu_torch.engine import solver
  from myosuite_mjx_tpu_torch.envs.base import BatchedEnv
  from myosuite_mjx_tpu_torch.ops import cuda_linalg

  tr, dev = ctx.cell.traffic, ctx.device
  B = int(tr["batch"])
  env_seed, act_seed, check_seed = ctx.seeds(3)
  env = envs.make(tr["task"], model_path=ctx.scene)
  _expect(env, tr)
  benv = BatchedEnv(env, B, dev, seed=env_seed)
  g = torch.Generator(device=dev).manual_seed(act_seed)
  pool = int(tr["action_pool"])
  actions = torch.rand((pool, B, env.action_dim), generator=g, device=dev,
                       dtype=env.dtype) * 2.0 - 1.0
  st = benv.init()
  first = _snap(st)
  st = st.replace(steps=torch.randint(0, env.horizon, (B,), generator=g,
                                      device=dev, dtype=torch.int32))
  states = [_snap(st)]          # states[i] is the state before step i
  warm = int(tr["warmup_steps"])
  for i in range(warm):
    st = benv.step(st, actions[i % pool])
    states.append(_snap(st))

  window = trace.Window(dev) if ctx.trace else None
  device.sync(dev)
  syncs0 = solver.newton_host_syncs.count
  launches0 = cuda_linalg.spd_solve_cuda.launches
  t_start = time.perf_counter()
  setup_s = t_start - ctx.t0
  if window is not None:
    window.__enter__()
  n = 0
  while True:
    st = benv.step(st, actions[(warm + n) % pool])
    states.append(_snap(st))
    n += 1
    if (n >= int(tr["trace_steps"]) if window is not None
        else time.perf_counter() - t_start >= ctx.seconds):
      break
  device.sync(dev)
  wall = time.perf_counter() - t_start
  if window is not None:
    window.__exit__(None, None, None)
  syncs = solver.newton_host_syncs.count - syncs0
  launches = cuda_linalg.spd_solve_cuda.launches - launches0
  memory_peak = device.memory_peak(dev)
  substeps = n * env.frame_skip
  window_states = states[warm + 1:]
  failed = sum(int(not (torch.isfinite(s["obs"]).all()
                        and torch.isfinite(s["reward"]).all()))
               for s in window_states)
  rows_in_force = float(torch.stack(
      [s["force_rows"].double().mean() for s in window_states]).mean())
  model = env.model
  itemsize = torch.empty((), dtype=env.dtype).element_size()
  del benv, env, st
  device.release(dev)

  numbers = check(ctx, tr, B, env_seed, check_seed, first, states, actions)
  return {
      "e2e": {"physics_steps_per_s": n * tr["frame_skip"] * B / wall,
              "setup_s": setup_s},
      "attempted": n, "failed": failed, "memory_peak_bytes": memory_peak,
      "numbers": numbers, "trace": window.result if window else None,
      "layer": {"substeps": substeps, "batch": B, "newton_syncs": syncs,
                "spd_launches": launches, "nv": int(model.nv),
                "nu": int(model.nu), "rows_in_force": rows_in_force,
                "itemsize": itemsize},
  }


def check(ctx, tr: dict, B: int, env_seed: int, check_seed: int,
          first: dict, states: list, actions: torch.Tensor) -> dict:
  """The reference, in float64 on the card, over every row of the first
  reset and of ``check_steps`` control steps drawn from the seed; the reset
  draws are replayed from the env's seed. With ``ctx.control`` the answers
  judged are not the program's but the control's: the reference in TF32
  (``precision.tf32``), from the same inputs."""
  dev, pool = ctx.device, actions.shape[0]
  ref = ref_step.make_env(tr["reference"], ctx.scene, torch.float64)
  ctl = None
  if ctx.control:
    ctl = ref_step.make_env(tr["reference"], ctx.scene, torch.float32)
  gens = [torch.Generator(device=dev).manual_seed(env_seed)
          for _ in range(2)]
  total = len(states) - 1
  rng = np.random.default_rng(check_seed)
  picks = set(rng.choice(total, size=min(int(tr["check_steps"]), total),
                         replace=False).tolist())
  block = int(tr["check_block"])
  blocks = [slice(i, min(i + block, B)) for i in range(0, B, block)]

  def gather(fn, env, inputs):
    parts = [fn(env, inputs, rows) for rows in blocks]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}

  def answers(fn, prog, inputs):
    out = gather(fn, ref, inputs[0])
    if ctl is not None:
      with precision.tf32():
        prog = gather(fn, ctl, inputs[1])
    return compare.row_errors(prog, out)

  errors, mismatched = [], 0
  with torch.no_grad():
    inputs = [ref_step.reset_inputs(e, B, dev, g)
              for e, g in zip((ref, ctl or ref), gens)]
    e, m = answers(lambda env, inp, rows: ref_step.reset_rows(
        env, inp, rows, dev), first, inputs)
    errors.append(e)
    mismatched += m
    for j in range(max(picks) + 1):
      inputs = [ref_step.reset_inputs(e, B, dev, g)
                for e, g in zip((ref, ctl or ref), gens)]
      if j not in picks:
        continue
      e, m = answers(lambda env, inp, rows: ref_step.autoreset_rows(
          env, states[j], actions[j % pool], inp, rows, dev),
          states[j + 1], inputs)
      errors.append(e)
      mismatched += m
  return {**compare.summarize(errors, mismatched),
          "checked_steps": sorted(picks)}


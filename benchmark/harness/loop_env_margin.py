"""The closed loop of ``loop_env.py``, judged with each termination's
margin.

A task that ends episodes on thresholds (a height, a heading) decides an
env's ``done`` by the sign of a margin. Where the reference's margin after
the step lies within the traffic's band of zero, float32 rounding alone can
put the program on the other side of the threshold, and the env's next
state is then another episode's. Such a row is held to the reference's
answer on the program's side of the threshold: the fresh episode where the
program reset the env, the stepped state where it did not, and the reward
with that side's ``done`` term. Every other row is held to the reference's
own answer, exactly as in ``loop_env.py``, and so is the first reset.

Beside the numbers of ``compare.summarize`` the check reports
``band_flips``, the rows whose ``done`` the program decided the other way
within the band, and ``margin_gap``, the largest gap between the program's
margins and the reference's over the rows that neither side reset, as a
share of its band (both by the reference's kinematics at each side's
positions after the step): the reading that the band is set from.

Traffic parameters: those of ``loop_env.py`` (whose timed loop runs as it
is), with ``"loop": "env_margin"`` and ``margin_band``: {margin: band}, for
a reference task with ``termination_margins(data)``: {margin: signed
distance [n], negative where the episode ends}.
"""
from __future__ import annotations

import types

import numpy as np
import torch

from benchmark.harness import compare, loop_env, precision
from benchmark.reference import data as data_mod
from benchmark.reference import forward as forward_mod
from benchmark.reference import step as ref_step
from benchmark.reference.base import _select


def margins_at(env, qpos: torch.Tensor, device) -> dict:
  """The task's margins at positions ``qpos``, by the reference's
  kinematics in the reference's precision."""
  dm = env.device_model(device)
  qpos = qpos.to(device=device, dtype=env.dtype)
  d = data_mod.make_data(dm, qpos.shape[0], env.dtype, device)
  return env.termination_margins(forward_mod.fwd_position(dm, d.replace(
      qpos=qpos)))


def margin_rows(env, pre: dict, action: torch.Tensor, inputs: dict, rows,
                device, prog: dict, band: dict) -> dict:
  """``ref_step.autoreset_rows`` of the envs ``rows``, where each env's
  ``done`` is the program's (``prog``) if a margin after the step lies
  within its band, else the reference's own. Adds ``band_flips`` (the
  rows decided the other way within the band) and ``margin_gap`` (each
  row's largest margin gap as a share of its band; 0 where either side
  reset the env)."""
  state = ref_step.state_rows(env, pre, rows, device)
  nxt = env.step(state, action[rows].to(device=device, dtype=env.dtype))
  fresh = ref_step.fresh_rows(env, inputs, rows, device)
  margins = env.termination_margins(nxt.data)
  near = torch.zeros_like(nxt.done)
  for k, b in band.items():
    near |= margins[k].abs() <= b
  terminated = torch.where(near, prog["done"][rows].to(device), nxt.done)
  truncated = env.truncated(nxt) & ~terminated
  kept = terminated | truncated
  out = _select(kept, fresh, nxt)
  flipped = terminated != nxt.done
  weight = float(env.rwd_keys_wt.get("done", 0.0))
  reward = nxt.reward + weight * (terminated.to(nxt.reward.dtype)
                                  - nxt.done.to(nxt.reward.dtype))
  stepped = ~kept & ~(prog["done"][rows] | prog["truncated"][rows]).to(
      device)
  # both sides' margins by one function of their positions after the step
  # (the step's own margins read the last substep's kinematics)
  theirs = margins_at(env, prog["qpos"][rows], device)
  ours = margins_at(env, nxt.data.qpos, device)
  gap = torch.stack([(theirs[k] - ours[k]).abs() / b
                     for k, b in band.items()]).amax(0)
  return {"qpos": out.data.qpos, "qvel": out.data.qvel, "act": out.data.act,
          "obs": out.obs, "reward": reward, "steps": out.steps,
          "done": terminated, "truncated": truncated, "band_flips": flipped,
          "margin_gap": torch.where(stepped, gap, torch.zeros_like(gap))}


def check(ctx, tr: dict, B: int, env_seed: int, check_seed: int,
          first: dict, states: list, actions: torch.Tensor) -> dict:
  """``loop_env.check`` with each checked step's rows from ``margin_rows``:
  the reference in float64 on the card over every row of the first reset
  and of ``check_steps`` control steps drawn from the seed. With
  ``ctx.control`` the answers judged are the control's (the reference in
  TF32, each env's ``done`` its own)."""
  dev, pool = ctx.device, actions.shape[0]
  ref = ref_step.make_env(tr["reference"], ctx.scene, torch.float64)
  ctl = None
  if ctx.control:
    ctl = ref_step.make_env(tr["reference"], ctx.scene, torch.float32)
  band = {k: float(v) for k, v in tr["margin_band"].items()}
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

  def judged(fn, prog, inputs):
    if ctl is None:
      return prog
    with precision.tf32():
      return gather(fn, ctl, inputs)

  errors, mismatched, flips, gap = [], 0, 0, 0.0
  with torch.no_grad():
    inputs = [ref_step.reset_inputs(e, B, dev, g)
              for e, g in zip((ref, ctl or ref), gens)]
    reset = lambda env, inp, rows: ref_step.reset_rows(env, inp, rows, dev)
    e, m = compare.row_errors(judged(reset, first, inputs[1]),
                              gather(reset, ref, inputs[0]))
    errors.append(e)
    mismatched += m
    for j in range(max(picks) + 1):
      inputs = [ref_step.reset_inputs(e, B, dev, g)
                for e, g in zip((ref, ctl or ref), gens)]
      if j not in picks:
        continue
      pre, action = states[j], actions[j % pool]
      prog = judged(lambda env, inp, rows: ref_step.autoreset_rows(
          env, pre, action, inp, rows, dev), states[j + 1], inputs[1])
      out = gather(lambda env, inp, rows: margin_rows(
          env, pre, action, inp, rows, dev, prog, band), ref, inputs[0])
      flips += int(out.pop("band_flips").sum())
      gap = max(gap, float(out.pop("margin_gap").max()))
      e, m = compare.row_errors(prog, out)
      errors.append(e)
      mismatched += m
  return {**compare.summarize(errors, mismatched), "band_flips": flips,
          "margin_gap": gap, "checked_steps": sorted(picks)}


# the timed loop of ``loop_env.run`` as it is, with this module's check
run = types.FunctionType(loop_env.run.__code__,
                         {**vars(loop_env), "check": check}, "run")
run.__doc__ = loop_env.run.__doc__

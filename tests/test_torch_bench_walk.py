"""The benchmark's walk cell on the CPU: the port's ``WalkEnv`` against the
frozen plain reference ``benchmark/reference/walk.py``, the margin rule of
the cell's check (``benchmark/harness/loop_env_margin.py``), and the
harness's whole check of the cell ``legs80-walk-b4096`` at a tiny batch.

- legs16 on MyoLeg's knees (``assets/legs16_knee.npz``, 14 knee
  equalities), B = 4, float64, myoLegWalk-v0's kwargs: the random reset
  from one seed on both sides (the same draws, in the same order), then 3
  autoreset steps from the same actions, with two envs' clocks one step
  from the horizon at the first, so that they truncate and take their
  fresh episode. qpos, qvel, obs and reward agree to 1e-12; done,
  truncated and steps exactly.
- The margin rule, in float64 on the reference alone: a "program" whose
  ``min_height`` sits 1e-5 m above the lowest env's height after the
  step ends that env's episode where the reference does not. Within a
  band of 1e-4 the row is held to the reference's fresh episode and
  matches it exactly; within 1e-6 it is a mismatch, as it is under the
  plain check.
- The cell through ``benchmark.run.measure(..., device="cpu")`` at B 8:
  the port in float32 against the reference in float64 reads ``correct``
  under the cell's limits.
"""
from __future__ import annotations

import os

import torch

from benchmark import run as bench_run
from benchmark.harness import compare, lookup
from benchmark.harness import loop_env_margin as margin
from benchmark.reference import step as ref_step
from benchmark.reference import walk as ref_walk
from myosuite_mjx_tpu_torch import envs

B = 4
ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "myosuite_mjx_tpu_torch", "assets")
LEGS16 = os.path.join(ASSETS, "legs16_knee.npz")
CELL = "legs80-walk-b4096"


def _close(x, y):
  torch.testing.assert_close(x, y, rtol=1e-12, atol=1e-12)


def test_reference_walk_is_the_ports_in_float64():
  port = envs.make("legs16Walk-v0", dtype=torch.float64, model_path=LEGS16)
  ref = ref_walk.WalkEnv(model_path=LEGS16, dtype=torch.float64,
                         **ref_walk.LEG_WALK)
  assert port.model.neq == 14
  assert (port.frame_skip, port.horizon) == (ref.frame_skip, ref.horizon)
  gens = [torch.Generator().manual_seed(5) for _ in range(2)]
  sp, sr = port.reset(B, "cpu", gens[0]), ref.reset(B, "cpu", gens[1])
  for x, y in ((sp.data.qpos, sr.data.qpos), (sp.data.qvel, sr.data.qvel),
               (sp.obs, sr.obs), (sp.reward, sr.reward)):
    _close(x, y)
  # the random reset drew noise: the envs start apart
  assert not torch.equal(sp.data.qpos[0], sp.data.qpos[1])
  clocks = torch.tensor([0, port.horizon - 1, 7, port.horizon - 1],
                        dtype=torch.int32)
  sp, sr = sp.replace(steps=clocks), sr.replace(steps=clocks.clone())
  a = torch.Generator().manual_seed(6)
  truncated = []
  for _ in range(3):
    act = torch.rand((B, port.action_dim), generator=a,
                     dtype=torch.float64) * 2 - 1
    sp = port.autoreset_step(sp, act, gens[0])
    sr = ref.autoreset_step(sr, act, gens[1])
    for x, y in ((sp.data.qpos, sr.data.qpos), (sp.data.qvel, sr.data.qvel),
                 (sp.obs, sr.obs), (sp.reward, sr.reward)):
      _close(x, y)
    assert torch.equal(sp.steps, sr.steps)
    assert torch.equal(sp.done, sr.done)
    assert torch.equal(sp.info["truncated"], sr.info["truncated"])
    truncated.append(sp.info["truncated"])
  assert truncated[0].tolist() == [False, True, False, True]
  # the truncated envs started over: their clocks count from the reset
  assert sp.steps.tolist()[1::2] == [2, 2]


def test_margin_rule_excuses_a_flip_only_within_its_band():
  walk = lambda **kw: ref_walk.WalkEnv(model_path=LEGS16,
                                       dtype=torch.float64,
                                       **{**ref_walk.LEG_WALK, **kw})
  ref = walk()
  g = torch.Generator().manual_seed(7)
  st = ref.reset(B, "cpu", g)
  pre = {k: getattr(st.data, k) for k in ref_step.STATE_KEYS}
  pre.update(steps=st.steps, **{"aux." + k: v for k, v in st.aux.items()})
  action = torch.rand((B, ref.action_dim), generator=g,
                      dtype=torch.float64) * 2 - 1
  inputs = ref_step.reset_inputs(ref, B, "cpu", g)
  rows = slice(0, B)
  state = ref_step.state_rows(ref, pre, rows, "cpu")
  height = ref.termination_margins(ref.step(state, action).data)["height"]
  low = int(height.argmin())
  h0 = float(height[low]) + ref.min_height
  # the "program" ends the lowest env's episode: its threshold is 1e-5 m
  # above that env's height, the reference's 1e-5 m below
  prog_env, ref_env = walk(min_height=h0 + 1e-5), walk(min_height=h0 - 1e-5)
  prog = ref_step.autoreset_rows(prog_env, pre, action, inputs, rows, "cpu")
  ended = [i == low for i in range(B)]
  assert prog["done"].tolist() == ended
  plain = ref_step.autoreset_rows(ref_env, pre, action, inputs, rows, "cpu")
  assert compare.row_errors(prog, plain)[1] == 1
  for band, mismatched in ((1e-4, 0), (1e-6, 1)):
    out = margin.margin_rows(ref_env, pre, action, inputs, rows, "cpu",
                             prog, {"height": band, "heading": band})
    assert out["band_flips"].tolist() == [e and mismatched == 0
                                          for e in ended]
    errors, m = compare.row_errors(prog, out)
    assert m == mismatched
    if band == 1e-4:
      # the excused row is the reference's fresh episode, done's reward
      # term included; the rows that neither side reset have no gap
      for k in compare.FLOAT_KEYS:
        assert float(errors[k].max()) == 0.0, k
      assert out["margin_gap"].tolist() == [0.0, 0.0, 0.0, 0.0]


def test_the_walk_cell_passes_the_check_on_the_cpu():
  cell = lookup.cell(CELL)
  assert cell.traffic["task"] == "legs80Walk-v0"
  assert cell.traffic["loop"] == "env_margin"
  cell.traffic.update(batch=8, action_pool=4, warmup_steps=1, check_steps=2,
                      check_block=4)
  out = bench_run.measure(cell, 2 ** 31 + 17, 0.2, False, device="cpu")
  assert out["correct"], out["numbers"]
  assert out["attempted"] >= 1 and out["failed"] == 0
  assert out["layer"]["nv"] == 34 and out["layer"]["nu"] == 80
  assert out["numbers"]["band_flips"] == 0
  assert 0 < out["numbers"]["margin_gap"] < 1

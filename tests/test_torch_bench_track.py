"""The benchmark's tracking cell on the CPU: the port's ``TrackEnv``
against the frozen plain reference ``benchmark/reference/track.py`` (and
its ``reference_motion.py``), the margin rule of the cell's check
(``benchmark/harness/loop_env_margin.py``) on the task's terminations, and
the configuration's byte copies.

- track29 under ``track29CubesmallLift-v0`` (the Lift clip, B = 4,
  float64): the reset, then 3 autoreset steps from the same actions, with
  two envs' clocks one step from the horizon at the first, so that they
  truncate and take their fresh episode. qpos, qvel, obs and reward agree
  to 1e-12; done, truncated and steps exactly.
- One env placed with the cube 26 cm from its target ends its episode on
  both sides, and its ``object`` margin is negative.
- The margin rule, in float64 on the reference alone: a "program" whose
  base threshold (the cube's distance from the wrist) sits 1e-5 m below
  one env's distance after the step ends that env's episode where the
  reference does not. Within a band of
  1e-4 the row is held to the reference's fresh episode and matches it,
  done's reward term (the task weighs none) included; within 1e-6 it is a
  mismatch.
- ``benchmark/configs/track29.npz`` and ``track29_lift_clip.npz`` are
  byte copies of the port's assets, and the reference's clip lookup gives
  the port's between frames and past the clip's end.
- The cell ``track29-lift-b4096`` through ``benchmark.run.measure(...,
  device="cpu")`` at B 8 reads ``correct`` under the cell's limits.
"""
from __future__ import annotations

import filecmp
import os

import pytest
import torch

from benchmark.harness import compare, lookup
from benchmark.harness import loop_env_margin as margin
from benchmark.reference import reference_motion as ref_motion
from benchmark.reference import step as ref_step
from myosuite_mjx_tpu_torch import envs
from myosuite_mjx_tpu_torch.logger import reference_motion as port_motion

B = 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(ROOT, "myosuite_mjx_tpu_torch", "assets")
CELL = "track29-lift-b4096"


def _close(x, y):
  torch.testing.assert_close(x, y, rtol=1e-12, atol=1e-12)


def _envs(dtype=torch.float64, **kw):
  cell = lookup.cell(CELL)
  tr, scene = cell.traffic, lookup.scene_path(cell.config)
  port = envs.make(tr["task"], model_path=scene, dtype=dtype)
  spec = {**tr["reference"], "kwargs": {**tr["reference"]["kwargs"], **kw}}
  return port, ref_step.make_env(spec, scene, dtype)


def test_reference_track_is_the_ports_in_float64():
  port, ref = _envs()
  assert (port.model.nv, port.model.nu, port.model.na) == (35, 45, 39)
  assert (port.frame_skip, port.horizon) == (ref.frame_skip, ref.horizon)
  assert port._lift_z == ref._lift_z
  gens = [torch.Generator().manual_seed(5) for _ in range(2)]
  sp, sr = port.reset(B, "cpu", gens[0]), ref.reset(B, "cpu", gens[1])
  for x, y in ((sp.data.qpos, sr.data.qpos), (sp.data.qvel, sr.data.qvel),
               (sp.obs, sr.obs), (sp.reward, sr.reward)):
    _close(x, y)
  clocks = torch.tensor([0, port.horizon - 1, 7, port.horizon - 1],
                        dtype=torch.int32)
  sp, sr = sp.replace(steps=clocks), sr.replace(steps=clocks.clone())
  a = torch.Generator().manual_seed(6)
  truncated, forces = [], 0
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
    forces += int((sp.data.contact_force != 0).sum())
  assert truncated[0].tolist() == [False, True, False, True]
  assert sp.steps.tolist()[1::2] == [2, 2]
  # the cube rests on the table: contacts hold force
  assert forces > 0


def test_a_cube_26_cm_from_its_target_ends_the_episode():
  port, ref = _envs()
  qpos = torch.as_tensor(port.init_qpos).expand(B, -1).clone()
  rd = port.ref.robot_dim
  # the object's x slide: its com 26 cm from the clip's first target
  qpos[2, rd] += 0.26
  qvel = torch.zeros((B, port.model.nv), dtype=torch.float64)
  sp, sr = port.reset_to(qpos, qvel), ref.reset_to(qpos, qvel)
  assert sp.done.tolist() == [False, False, True, False]
  assert torch.equal(sp.done, sr.done)
  margins = ref.termination_margins(sr.data)
  assert float(margins["object"][2]) < 0
  assert (margins["object"][[0, 1, 3]] > 0).all()
  _close(sp.reward, sr.reward)


def test_margin_rule_excuses_a_flip_only_within_its_band():
  _, ref = _envs()
  g = torch.Generator().manual_seed(7)
  st = ref.reset(B, "cpu", g)
  pre = {k: getattr(st.data, k) for k in ref_step.STATE_KEYS}
  pre.update(steps=st.steps, **{"aux." + k: v for k, v in st.aux.items()})
  action = torch.rand((B, ref.action_dim), generator=g,
                      dtype=torch.float64) * 2 - 1
  inputs = ref_step.reset_inputs(ref, B, "cpu", g)
  rows = slice(0, B)
  state = ref_step.state_rows(ref, pre, rows, "cpu")
  base = ref.termination_margins(ref.step(state, action).data)["base"]
  far = int(base.argmin())
  dist = ref.base_fail_thresh - float(base[far])

  def with_threshold(t):
    _, env = _envs()
    env.base_fail_thresh = t
    return env

  # the "program" ends the env whose cube is farthest from the wrist: its
  # threshold is 1e-5 m below that distance, the reference's 1e-5 m above
  prog_env, ref_env = with_threshold(dist - 1e-5), with_threshold(dist + 1e-5)
  prog = ref_step.autoreset_rows(prog_env, pre, action, inputs, rows, "cpu")
  ended = [i == far for i in range(B)]
  assert prog["done"].tolist() == ended
  plain = ref_step.autoreset_rows(ref_env, pre, action, inputs, rows, "cpu")
  assert compare.row_errors(prog, plain)[1] == 1
  for band, mismatched in ((1e-4, 0), (1e-6, 1)):
    out = margin.margin_rows(ref_env, pre, action, inputs, rows, "cpu",
                             prog, {"object": band, "base": band})
    assert out["band_flips"].tolist() == [e and mismatched == 0
                                          for e in ended]
    errors, m = compare.row_errors(prog, out)
    assert m == mismatched
    if band == 1e-4:
      # the excused row is the reference's fresh episode; the task weighs
      # its termination under "penalty", so the program's reward for that
      # row is the one corrected by "done", none here
      assert "done" not in ref_env.rwd_keys_wt
      for k in compare.FLOAT_KEYS:
        if k != "reward":
          assert float(errors[k].max()) == 0.0, k
      others = [i for i in range(B) if i != far]
      assert float(errors["reward"][others].max()) == 0.0
      assert out["margin_gap"].tolist() == [0.0] * B


def test_byte_copies_are_the_ports_assets():
  configs = os.path.join(ROOT, "benchmark", "configs")
  for copy, asset in (("track29.npz", "track29.npz"),
                      ("track29_lift_clip.npz", "track29_lift_clip.npz")):
    assert filecmp.cmp(os.path.join(configs, copy),
                       os.path.join(ASSETS, asset), shallow=False)


def test_reference_lookup_is_the_ports():
  clip = os.path.join(ASSETS, "track29_lift_clip.npz")
  port = port_motion.ReferenceMotion(clip, dtype=torch.float64)
  ref = ref_motion.ReferenceMotion(clip, dtype=torch.float64)
  assert ref.type == ref_motion.ReferenceType.TRACK
  # on frames, between them, at the last and past the clip's end (2 s)
  time = torch.tensor([0.0, 0.05, 0.0371, 0.4449, 1.3, 1.99, 2.0, 2.7],
                      dtype=torch.float64)
  a, b = port.get_reference(time), ref.get_reference(time)
  for k in ("robot", "robot_vel", "object"):
    assert torch.equal(a[k], b[k]), k
  # past the end the last frame holds
  assert torch.equal(b["object"][-1], b["object"][-2])
  assert float(b["object"][-1, 2]) == pytest.approx(0.15, abs=1e-12)


def test_the_lift_cell_passes_the_check_on_the_cpu():
  """The cell through ``benchmark.run.measure(..., device="cpu")`` at B 8:
  the port in float32 against the reference in float64 reads ``correct``
  under the cell's limits, on the cell's margin band."""
  from benchmark import run as bench_run
  cell = lookup.cell(CELL)
  assert cell.traffic["task"] == "track29CubesmallLift-v0"
  assert cell.traffic["loop"] == "env_margin"
  cell.traffic.update(batch=8, action_pool=4, warmup_steps=1, check_steps=2,
                      check_block=4)
  out = bench_run.measure(cell, 2 ** 31 + 17, 0.2, False, device="cpu")
  assert out["correct"], out["numbers"]
  assert out["attempted"] >= 1 and out["failed"] == 0
  assert out["layer"]["nv"] == 35 and out["layer"]["nu"] == 45
  assert out["numbers"]["band_flips"] == 0
  assert 0 <= out["numbers"]["margin_gap"] < 1

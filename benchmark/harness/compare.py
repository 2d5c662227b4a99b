"""The comparison that decides ``correct``: the program's answers against
the plain reference's, and each number beside its limit.

An env step's answer is one env's row: its next qpos, qvel, act, obs and
reward (compared by size), and its episode clock, termination and
truncation (compared exactly). A row's error is the largest gap over its
float entries, each divided by the reference's RMS of that column over
the batch, floored at a tenth of the quantity's RMS (so that a column that
is all but still, such as a resting object's velocity, is judged on the
quantity's scale). The numbers: the median row error over every compared
row (how close the whole batch is); the root mean square, over every
compared row, of a row's median qpos error (positions integrate every
force of the control step; a contact that starts a substep earlier on one
side moves a few joints of a row, not most, and one env's answer that is
wrong, such as another env's, moves this number by its own error over the
square root of the rows compared); and the count of rows whose exact
fields differ. The largest row error over every field, and the largest
row's median qpos error, are reported beside them.
"""
from __future__ import annotations

import math

import torch

FLOAT_KEYS = ("qpos", "qvel", "act", "obs", "reward")
EXACT_KEYS = ("steps", "done", "truncated")


def row_errors(prog: dict, ref: dict) -> tuple[dict, int]:
  """({field: error of each row [n]} in float64 on the CPU, rows whose
  exact fields differ). A row with a non-finite float entry reads inf."""
  n = ref["qpos"].shape[0]
  errs = {}
  for k in FLOAT_KEYS:
    p = prog[k].detach().to("cpu", torch.float64).reshape(n, -1)
    r = ref[k].detach().to("cpu", torch.float64).reshape(n, -1)
    if r.shape[1] == 0:
      continue
    col = r.square().mean(0).sqrt()
    floor = 0.1 * float(r.square().mean().sqrt()) + 1e-12
    rel = (p - r).abs() / torch.clamp(col, min=floor)
    e = rel.amax(1)
    errs[k] = torch.where(torch.isfinite(p).all(1), e,
                          torch.full_like(e, math.inf))
    errs["cols." + k] = rel.median(0).values
    if k == "qpos":
      errs["qpos.row_median"] = torch.where(
          torch.isfinite(p).all(1), rel.median(1).values,
          torch.full_like(e, math.inf))
  bad = torch.zeros(n, dtype=torch.bool)
  for k in EXACT_KEYS:
    bad |= (prog[k].detach().cpu().reshape(n, -1).to(torch.int64)
            != ref[k].detach().cpu().reshape(n, -1).to(torch.int64)).any(1)
  return errs, int(bad.sum())


def summarize(errors: list, mismatched: int) -> dict:
  """The numbers: median row error, RMS of the rows' median qpos errors,
  mismatched rows; beside them the largest row error and the largest
  row's median qpos error."""
  fields = [k for k in FLOAT_KEYS if k in errors[0]]
  row = torch.cat([torch.stack([e[k] for k in fields]).amax(0)
                   for e in errors])
  qpos = torch.cat([e["qpos.row_median"] for e in errors])
  out = {"row_err_median": float(row.median()),
         "qpos_err_rms": float(qpos.square().mean().sqrt()),
         "exact_mismatch_rows": float(mismatched),
         "row_err_max": float(row.max()), "qpos_err_max": float(qpos.max())}
  for k in fields:     # where the errors sit, for a look at the readings
    out["median." + k] = [float(e[k].median()) for e in errors]
    out["worst_col." + k] = [int(e["cols." + k].argmax()) for e in errors]
  return out


def judge(numbers: dict, limits: dict) -> bool:
  """True when every number is at or under its limit (a NaN fails)."""
  return all(numbers[k] <= limits[k]["limit"] for k in limits)


def lines(numbers: dict, limits: dict) -> list:
  """One plain line per number compared: its name, its value, its limit."""
  return [f"check {k} {numbers[k]!r} limit {limits[k]['limit']!r}"
          for k in limits]

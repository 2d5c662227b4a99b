"""Plain reference, frozen from the port's ``envs/fatigue.py`` and
importing nothing of it.

3CC-r cumulative muscle fatigue on a batch of environments.

Counterpart of ``myosuite_mjx_tpu/envs/fatigue.py``: three compartments per
muscle (MA active, MR resting, MF fatigued), the transfer rate C(t) from the
muscle activation time constants, recovery boosted by the rest multiplier.
The compartments live in the env's ``aux["fatigue"]``, each [B, na], and
the update is branchless.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class FatigueParams:
  F: float = 0.00912           # fatigue coefficient
  R: float = 0.1 * 0.00094     # recovery coefficient
  r: float = 10 * 15           # rest-recovery multiplier


def init_state(batch: int, na: int, dtype: torch.dtype = torch.float32,
               device="cuda") -> dict:
  """Fully rested muscles."""
  z = torch.zeros((batch, na), dtype=dtype, device=device)
  return {"MA": z, "MR": torch.ones_like(z), "MF": z.clone()}


def random_state(non_fatigued: torch.Tensor,
                 active_pct: torch.Tensor) -> dict:
  """Compartments from two U(0, 1) draws [B, na]: the non-fatigued share,
  and the active share of it."""
  return {"MA": non_fatigued * active_pct,
          "MR": non_fatigued * (1 - active_pct),
          "MF": 1 - non_fatigued}


def compute_act(state: dict, target_load: torch.Tensor,
                tauact: torch.Tensor, taudeact: torch.Tensor, dt: float,
                p: FatigueParams = FatigueParams()):
  """One fatigue update; returns (effective activation MA, new state)."""
  MA, MR, MF = state["MA"], state["MR"], state["MF"]
  TL = target_load

  LD = (0.5 + 1.5 * MA) / tauact
  LR = (0.5 + 1.5 * MA) / taudeact

  below = MA < TL
  enough_rest = MR > (TL - MA)
  C = torch.where(below,
                  torch.where(enough_rest, LD * (TL - MA), LD * MR),
                  LR * (TL - MA))
  rR = torch.where(MA >= TL, MA.new_tensor(p.r * p.R), MA.new_tensor(p.R))

  C = torch.clamp(
      C,
      torch.maximum(-MA / dt + p.F * MA, (MR - 1) / dt + rR * MF),
      torch.minimum((1 - MA) / dt + p.F * MA, MR / dt + rR * MF))

  # simultaneous update: all deltas use the pre-update compartments
  dMA = (C - p.F * MA) * dt
  dMR = (-C + rR * MF) * dt
  dMF = (p.F * MA - rR * MF) * dt
  MA, MR, MF = MA + dMA, MR + dMR, MF + dMF
  return MA, {"MA": MA, "MR": MR, "MF": MF}

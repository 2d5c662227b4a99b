"""The yardstick's arithmetic: published peaks, and the operations and bytes
that the work of a cell needs, counted from its sizes.

Every count is of the work the inputs need, whatever kernel does it, and is
a lower bound where the work depends on the data: a later change that
fuses or removes work does not change it.
"""
from __future__ import annotations

# Published peaks of one card (NVIDIA's data sheet, SXM part, dense, at the
# full 700 W power limit): float32 outside the tensor cores, since the port
# pins TF32 off, and HBM bandwidth.
PEAKS = {
    "H100": {"fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks(device_name: str) -> dict | None:
  """The peaks of the card named ``device_name``; None for a card not in
  the table (its shares are then not read)."""
  for key, p in PEAKS.items():
    if key in device_name:
      return p
  return None


def spd_flops(n: int) -> float:
  """One n x n SPD solve: a Cholesky factor (n^3/3 multiply-adds) and two
  triangular substitutions (n^2 each), at 2 FLOPs a multiply-add."""
  return 2.0 * (n ** 3 / 3.0 + 2.0 * n ** 2)


def spd_bytes(n: int, itemsize: int = 4) -> float:
  """One solve's compulsory traffic: A read, b read and x written, once
  each."""
  return float(n * n + 2 * n) * itemsize


def spd_least_seconds(n: int, batch: int, peak: dict,
                      itemsize: int = 4) -> float:
  """The least time one launch of ``batch`` solves can take on the card:
  the larger of its bytes over the bandwidth and its FLOPs over the float32
  peak."""
  return batch * max(spd_bytes(n, itemsize) / peak["hbm_bytes_per_s"],
                     spd_flops(n) / peak["fp32_flops"])


def substep_flops(nv: int, nu: int, rows_in_force: float) -> float:
  """A lower bound on one env's physics substep: three SPD solves at
  n = nv (M^-1 qfrc_smooth, one Newton step, the implicit integrator), one
  Newton iteration's J^T diag(D) J over the constraint rows in force and
  its two J products, and the actuator moment product (nu x nv); 2 FLOPs a
  multiply-add."""
  r = rows_in_force
  macs = r * nv * nv + 2 * r * nv + nu * nv
  return 3 * spd_flops(nv) + 2.0 * macs

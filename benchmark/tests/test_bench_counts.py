"""The yardstick's counts against numbers worked by hand."""
import pytest

from benchmark.harness import counts

H100 = counts.peaks("NVIDIA H100 80GB HBM3")


def test_spd_bound_hand23():
  # A, b and x at [4096, 23] float32: (529 + 46) * 4 B * 4096 = 9,420,800 B
  assert counts.spd_bytes(23) == 2300.0
  assert counts.spd_flops(23) == pytest.approx(2 * (12167 / 3 + 1058))
  least = counts.spd_least_seconds(23, 4096, H100)
  assert least == pytest.approx(9_420_800 / 3.35e12)       # 2.81 us: bytes
  assert counts.spd_flops(23) * 4096 / 67e12 < least


def test_substep_lower_bound():
  # hand23, every one of its 119 rows: 3 * 10,227.33 + 2 * (119 * 529
  # + 2 * 119 * 23 + 39 * 23) = 30,682 + 138,644
  assert counts.substep_flops(23, 39, 119) == pytest.approx(169_326)
  # arm27, 123 rows: 84,942 + 2 * (133,947 + 8,118 + 2,079)
  assert counts.substep_flops(33, 63, 123) == pytest.approx(373_230)
  assert counts.substep_flops(23, 39, 0) == pytest.approx(30_682 + 1_794)


def test_unknown_card_has_no_peaks():
  assert counts.peaks("NVIDIA A100-SXM4-80GB") is None

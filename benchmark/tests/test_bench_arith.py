"""Rates, percentiles, spreads, busy unions and bounds."""

import statistics

import pytest

from benchmark.lib import arith


def test_percentile_matches_statistics_inclusive():
    xs = [5.0, 1.0, 9.0, 3.0, 7.0, 2.0, 8.0, 4.0, 6.0, 10.0, 11.5]
    want = statistics.quantiles(xs, n=10, method="inclusive")[8]
    assert arith.percentile(xs, 90) == pytest.approx(want)
    assert arith.percentile([4.0], 90) == 4.0


def test_rate():
    assert arith.rate(90, 45.0) == 2.0


def test_busy_union():
    ivs = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 40)]
    assert arith.busy_s(ivs) == pytest.approx(25e-9)
    assert arith.union(ivs) == [[0, 15], [20, 30], [40, 40]]
    assert arith.busy_s([]) == 0.0


def test_bounds():
    ms, by = arith.bound_ms(989e12, 0, "bfloat16")
    assert (ms, by) == (pytest.approx(1e3), "operations")
    assert arith.bound_ms(165e12, 0, "float32", products=True)[0] == pytest.approx(1e3)
    assert arith.bound_ms(0, 3.35e12)[1] == "bytes"
    # K1 at the serving shape: 4 * H * T^2 * D * B FLOPs
    ms, _ = arith.k1_bound_ms(2, 752, 752, 8, 96, "bfloat16")
    assert ms == pytest.approx(max(4 * 8 * 752 * 752 * 96 * 2 / 989e12,
                                   (4 * 2 * 752 * 8 * 96 * 2 + 2 * 8 * 752 * 4) / 3.35e12) * 1e3)
    assert arith.bwd_bound_ms(8, 768, 768, 8, 96, "float32", "dkv")[0] > \
        arith.bwd_bound_ms(8, 768, 768, 8, 96, "float32", "dq")[0]

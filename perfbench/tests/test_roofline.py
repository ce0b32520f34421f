"""The corrected operation and byte counts of kernels 1 and 5."""

import pytest

from perfbench import roofline


def test_kernel1_charges_no_score_matrix():
    two_d, S, kappa = 256, 1 << 20, 512
    one = roofline.kernel1(1, two_d, S, kappa)
    two = roofline.kernel1(2, two_d, S, kappa)
    per_query = two.bytes - one.bytes
    # a query adds its terms and its pool, not a row of (B, Sp) scores
    # nor the design's per-slab pools
    assert per_query == two_d * 2 + kappa * 8
    assert per_query < S * 4


def test_kernel1_counts_each_input_once():
    B, two_d, S, kappa = 1024, 256, 1 << 20, 512
    w = roofline.kernel1(B, two_d, S, kappa)
    matrix = two_d * S * 2
    bias_mask = S * (4 + 1)
    terms = B * two_d * 2
    pool = B * kappa * 8
    assert w.bytes == matrix + bias_mask + terms + pool
    assert w.flops == 2.0 * B * two_d * S
    # at B=1024 over 1M rows the operations bound it, not the bytes
    assert w.flops / w.peak_flops > w.bytes / roofline.HBM_BPS
    # padding columns are no work: 1000 live rows cost what 1000 cost
    assert roofline.kernel1(B, two_d, 1000, kappa).flops == \
        2.0 * B * two_d * 1000


def test_kernel5_reads_each_distinct_row_once():
    B, C, D = 1024, 1024, 768
    a = roofline.kernel5(B, C, D, distinct_rows=300_000)
    b = roofline.kernel5(B, C, D, distinct_rows=600_000)
    assert b.bytes - a.bytes == 300_000 * D * 4
    assert a.flops == 3.0 * B * C * D


def test_share_is_the_least_time_over_the_device_time():
    w = roofline.Work(0.0, roofline.HBM_BPS * 1e-3, roofline.PEAK_BF16)
    w = w + roofline.Work(1.0, 0.0, roofline.PEAK_BF16)
    assert roofline.share(w, 2e-3) == pytest.approx(50.0, rel=1e-6)
    assert roofline.share(w, 0.0) is None

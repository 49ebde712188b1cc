"""The frozen yardstick: roofline arithmetic, statistics over every
sample, and the window's end-to-end quantities."""

import statistics

import numpy as np
import pytest

from cellbench.harness import roofline
from cellbench.harness.drivers import Record
from cellbench.harness.stats import percentile

N = 65536


def test_matvec_work_counts_each_byte_once():
    w = roofline.matvec_work(N, N, "bfloat16")
    assert w.bytes == (N * N + N + N) * 2
    assert w.flops == 2 * N * N
    assert w.bound() == "bytes"
    assert w.least_seconds() == pytest.approx(w.bytes / 3.35e12)
    assert w.least_seconds() * 1e3 == pytest.approx(2.5642378, rel=1e-7)


@pytest.mark.parametrize("width", [1, 3, 4, 32])
def test_block_work_counts_the_unpadded_width(width):
    w = roofline.block_work(N, N, width, "bfloat16")
    assert w.bytes == (N * N + N * width + N * width) * 2
    assert w.flops == 2 * N * N * width
    assert w.bound() == "bytes"


def test_a_square_block_is_bound_by_operations():
    w = roofline.block_work(4096, 4096, 4096, "bfloat16")
    assert w.bound() == "flops"
    assert w.least_seconds() == pytest.approx(2 * 4096 ** 3 / 989e12)


def test_cg_iteration_work():
    w = roofline.cg_iteration_work(N, "float32")
    assert w.bytes == (N * N + 8 * N) * 4
    assert w.flops == 2 * N * N + 10 * N
    assert w.least_seconds() * 1e3 == pytest.approx((N * N + 8 * N) * 4 / 3.35e9)


def test_share_percent():
    assert roofline.share_percent(1.0, 2.0) == 50.0
    assert roofline.share_percent(1.0, 0.0) is None


@pytest.mark.parametrize("q", [0, 50, 95, 99, 100])
def test_percentile_is_numpys_over_every_value(q):
    values = list(np.random.default_rng(3).exponential(size=1001))
    assert percentile(values, q) == pytest.approx(float(np.percentile(values, q)))


def test_tail_is_over_all_requests_not_over_chunks():
    # 19 quiet chunks and one slow one: the 95th percentile over all
    # requests sees the slow chunk, a median of the chunks' tails does not.
    chunks = [[1.0] * 100 for _ in range(19)] + [[50.0] * 100]
    flat = [v for chunk in chunks for v in chunk]
    assert statistics.median(percentile(c, 95) for c in chunks) == 1.0
    assert percentile(flat, 95) == pytest.approx(float(np.percentile(flat, 95)))
    assert percentile(flat, 96) == 50.0


def test_record_rates_and_tails_cover_the_whole_window():
    rec = Record(opened=0.0)
    for i in range(100):
        start = i * 0.01
        done = start + (0.5 if i >= 95 else 0.005)   # five end past the close
        rec.index.append(i)
        rec.pid.append(0)
        rec.width.append(2)
        rec.start.append(start)
        rec.submitted.append(start + 0.001)
        rec.done.append(done)
    rec.closed = max(rec.done)
    q = rec.quantities()
    assert q["cols_per_s"] == pytest.approx(200 / 1.49)
    assert q["ms_per_call"] == pytest.approx(1490 / 100)
    lat = [(d - s) * 1e3 for s, d in zip(rec.start, rec.done)]
    assert q["latency_p95_ms"] == pytest.approx(float(np.percentile(lat, 95)))
    assert q["latency_p95_ms"] > 5.0  # the stragglers count

"""The open-loop schedule, its timing from the due time, and the
percentiles over all requests."""

import math

import numpy as np
import pytest

from portbench import harness
from portbench.run import load_cell, traffic_kind

_, _, TRAFFIC = load_cell("search.b32.lib1m.fresh")
KIND = traffic_kind(TRAFFIC)


def test_schedule_same_arrivals_sizes_in_other_order():
    params = dict(TRAFFIC, rate=50)
    a = KIND.schedule(params, 2**33 + 7, 20.0)
    b = KIND.schedule(params, 11, 20.0)
    assert len(a) == len(b) == 1000
    for reqs in (a, b):
        offsets = [r[0] for r in reqs]
        assert offsets == sorted(offsets) and 0 < offsets[0] and offsets[-1] < 20.0
        assert len({r[1] for r in reqs}) == len(reqs)  # every text unique
        assert sum(r[2] == params["big_limit"] for r in reqs) == 250
        assert all(params["min_words"] <= len(r[1].split()) <= params["max_words"] for r in reqs)
    assert [r[0] for r in a] == [r[0] for r in b]  # one arrival sequence
    assert [r[2] for r in a] != [r[2] for r in b]
    assert sorted(len(r[1].split()) for r in a) == sorted(len(r[1].split()) for r in b)
    assert [len(r[1].split()) for r in a] != [len(r[1].split()) for r in b]
    assert KIND.schedule(params, 11, 20.0) == b


def test_sample_holds_the_longest():
    reqs = KIND.schedule(dict(TRAFFIC, rate=50), 3, 20.0)
    picked = KIND.sample(reqs, 64, 3)
    assert len(set(picked)) == 64
    longest = max(range(len(reqs)), key=lambda i: (reqs[i][2], len(reqs[i][1].split())))
    assert longest in picked


def test_latency_is_timed_from_due():
    reqs = [[0.5, "a", 12], [0.6, "b", 48], [0.7, "c", 12]]
    res = {"done": [0.52, 0.9, 0.71], "status": [200, 200, 500], "count": [12, 48, 0]}
    lat, failed = KIND.latencies_ms(reqs, res, rows=1000)
    assert lat[0] == pytest.approx(20.0) and lat[1] == pytest.approx(300.0)
    assert lat[2] == math.inf and failed == 1
    # a short answer fails too
    lat, failed = KIND.latencies_ms(reqs[:1], {"done": [0.6], "status": [200], "count": [11]}, 1000)
    assert failed == 1 and lat == [math.inf]


def test_percentiles_over_all_requests():
    values = [float(v) for v in range(1, 101)]
    assert harness.percentile(values, 0.5) == pytest.approx(50.5)
    assert harness.percentile(values, 0.95) == pytest.approx(95.05)
    # failed requests count, as the slowest
    with_failed = values[:98] + [math.inf, math.inf]
    assert harness.percentile(with_failed, 0.5) == pytest.approx(50.5)
    assert harness.percentile(with_failed, 0.95) == pytest.approx(95.05)
    assert harness.percentile(with_failed, 0.999) == math.inf

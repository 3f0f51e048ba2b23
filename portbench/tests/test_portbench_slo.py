"""Goodput, censoring and the tails on hand-made timelines."""

import pytest

from portbench import slo
from portbench.traffic import Spec


def rec(kind, due, out_len, stamps, ttft=2.0, tbt=0.1, ttlt=20.0,
        shed=False):
    s = Spec(0, due, kind, 10, out_len, ttft, tbt, ttlt, 0.0)
    return slo.Record(s, list(stamps), shed=shed)


def test_latency_met_and_missed():
    ok = rec("latency", 1.0, 3, [2.0, 2.05, 2.1])
    assert slo.judge(ok, 10.0) == slo.MET
    late_first = rec("latency", 1.0, 3, [3.5, 3.55, 3.6])
    assert slo.judge(late_first, 10.0) == slo.MISS
    # one gap of 0.3 s among 2: the 95th percentile (nearest rank below)
    # is the larger
    slow = rec("latency", 1.0, 3, [2.0, 2.3, 2.35])
    assert slo.judge(slow, 10.0) == slo.MISS


def test_tbt_percentile_rank():
    # 20 gaps: the rank is min(19, int(0.95 * 20)) = 19, the largest
    stamps = [1.0 + 0.05 * i for i in range(21)]
    stamps[-1] += 0.2
    assert slo.judge(rec("latency", 0.5, 21, stamps), 9.0) == slo.MISS
    # 40 gaps: rank 38, so one slow gap is allowed and two are not
    stamps = [1.0 + 0.05 * i for i in range(41)]
    one = stamps[:40] + [stamps[40] + 0.3]
    assert slo.judge(rec("latency", 0.5, 41, one), 9.0) == slo.MET
    two = stamps[:39] + [stamps[39] + 0.3, stamps[40] + 0.6]
    assert slo.judge(rec("latency", 0.5, 41, two), 9.0) == slo.MISS


def test_censoring_at_the_close():
    # no first token yet, limit not passed: censored; passed: a miss
    assert slo.judge(rec("latency", 9.0, 5, []), 10.0) == slo.CENSORED
    assert slo.judge(rec("latency", 7.0, 5, []), 10.0) == slo.MISS
    # running on time: censored; already too many slow gaps: a miss
    running = rec("latency", 8.0, 41, [8.5, 8.55, 8.6])
    assert slo.judge(running, 10.0) == slo.CENSORED
    slow = rec("latency", 8.0, 41, [8.5, 8.9, 9.3, 9.7])
    assert slo.judge(slow, 10.0) == slo.MISS
    # deadlines and best effort
    assert slo.judge(rec("throughput", 5.0, 9, [6.0]), 10.0) \
        == slo.CENSORED
    assert slo.judge(rec("throughput", 5.0, 9, [6.0], ttlt=4.0), 10.0) \
        == slo.MISS
    assert slo.judge(rec("none", 5.0, 9, [6.0]), 10.0) == slo.CENSORED
    assert slo.judge(rec("latency", 9.5, 5, [], shed=True), 10.0) \
        == slo.MISS


def test_goodput_output_and_tails():
    recs = [
        rec("latency", 0.5, 3, [1.0, 1.1, 1.2]),       # before the window
        rec("latency", 2.0, 4, [2.5, 2.55, 2.6, 2.65]),     # met
        rec("throughput", 3.0, 2, [3.5, 30.0], ttlt=5.0),   # missed
        rec("none", 4.0, 3, [4.5, 4.6, 4.7]),                # met
        rec("latency", 9.9, 3, []),                          # censored
    ]
    start, end = 1.5, 10.0
    assert slo.goodput_tok_s(recs, start, end) == pytest.approx(
        (4 + 3) / 8.5)
    # tokens reaching the host inside (start, end]
    assert slo.output_tok_s(recs, start, end) == pytest.approx(8 / 8.5)
    assert slo.ttfts(recs, start, end) == pytest.approx([0.5])
    assert sorted(slo.tbts(recs, start, end)) == pytest.approx(
        [0.05, 0.05, 0.05])
    assert slo.pctl([1, 2, 3, 4], 50) == 2.5 and slo.pctl([], 90) is None
    met, judged, cens = slo.attainment(recs, start, end)
    assert (met, judged, cens) == (2, 3, 1)

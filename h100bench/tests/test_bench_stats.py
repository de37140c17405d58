"""The end-to-end arithmetic: all work over all time, tails over all ticks."""

import statistics

import pytest

from h100bench import stats


def test_rate_is_all_work_over_all_time():
    assert stats.rate(2048 * 10, 2.0) == 10240.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_one_stall_moves_rate_and_tail_but_not_a_median_of_chunks():
    steady = [0.02] * 200
    # One stall of the host or the card that holds up twelve ticks in a row.
    stalled = steady[:100] + [0.1] * 12 + steady[112:]
    assert stats.rate(200 * 16, sum(stalled)) < 0.85 * stats.rate(200 * 16, sum(steady))
    assert stats.percentile(stalled, 95) == 0.1 > stats.percentile(steady, 95)
    chunks = lambda xs: [sum(xs[i : i + 20]) for i in range(0, len(xs), 20)]  # noqa: E731
    assert statistics.median(chunks(stalled)) == statistics.median(chunks(steady))


def test_percentile_nearest_rank():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == 95 and stats.percentile(xs, 50) == 50
    assert stats.percentile([3.0], 95) == 3.0


def test_union_of_overlapping_intervals():
    assert stats.union_length([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4
    assert stats.union_length([(0, 10), (2, 3), (4, 5)]) == 10
    assert stats.union_length([]) == 0
    assert stats.gaps([(1, 2), (1.5, 3), (5, 6)], 0, 7) == [(0, 1), (3, 5), (6, 7)]


def test_tick_p95_reader_takes_every_call_of_the_measured_window():
    from h100bench import manifest as mf
    from h100bench import readers

    reader = mf.metric("tick_ms_p95.live")
    steady = [0.02] * 200
    stalled = steady[:100] + [0.1] * 12 + steady[112:]
    read = lambda calls: reader.read(readers.Traced(None, 0, {}, {}, {"call_s": calls}))  # noqa: E731
    assert read(steady) == pytest.approx(20.0)
    assert read(stalled) == pytest.approx(100.0)
    assert read([]) is None

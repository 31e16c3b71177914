"""Percentiles and rates come from the raw samples of the whole window."""
import math

import numpy as np

from benchmark.harness import runner, stats


def test_percentile_is_nearest_rank_over_raw_samples():
    v = list(range(1, 101))                     # 1..100
    assert stats.percentile(v, 95) == 95
    assert stats.percentile(v, 50) == 50
    assert stats.percentile([7.0], 95) == 7.0
    assert stats.percentile([], 95) == math.inf


def test_a_failed_request_counts_as_missing():
    v = [10.0] * 95 + [math.inf] * 5
    assert stats.percentile(v, 95) == 10.0
    v = [10.0] * 94 + [math.inf] * 6
    assert stats.percentile(v, 95) == math.inf


def test_window_counts_issue_and_completion_times():
    # (client, n, slot, t_due, payload, t_done, result)
    recs = [(0, 0, 1, 0.5, 1, 1.5, True),      # before the window: not issued in it
            (0, 1, 1, 1.0, 1, 2.0, True),      # issued and done in it
            (0, 2, 1, 10.5, 1, 12.0, True),    # issued in it, done after
            (0, 3, 1, 2.0, 1, math.nan, None)]  # issued, never done
    w = runner.Window(1.0, 11.0, recs)
    assert [r[1] for r in w.issued()] == [1, 2, 3]
    assert [r[1] for r in w.done_in(1.0, 11.0)] == [0, 1]
    lat = runner.latencies_ms(w.issued(), lambda r: r[6] is not None)
    assert lat[0] == 1000.0 and lat[1] == 1500.0 and math.isinf(lat[2])


def test_spread_is_the_quartile_distance_over_the_median():
    assert abs(stats.spread([1, 2, 3, 4, 5, 6]) -
               (np.subtract(*np.array([5.25, 1.75])) / 3.5)) < 1e-12

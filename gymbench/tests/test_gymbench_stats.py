"""The end-to-end metrics' whole-window arithmetic."""

from gymbench import stats


def test_rate_is_all_work_over_all_time():
    # 7 iterations of 24 steps of 16384 envs in 2.5 s of window
    assert stats.rate(7 * 24 * 16384, 2.5) == 7 * 24 * 16384 / 2.5


"""The window's arithmetic on a fake clock."""

from harness.window import Job, Window, run_window


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _window(walls, seconds):
    clock = Clock()

    def job(i):
        clock.t += walls[i]
        return 10

    return run_window(job, seconds, clock)


def test_rate_and_p90_over_all_jobs():
    w = _window([1.0] * 20, 10.0)
    assert len(w.jobs) == 10 and w.seconds == 10.0
    assert w.rate() == 10.0 and w.percentile(90) == 1.0


def test_a_stall_lowers_the_rate_and_raises_p90():
    steady = _window([1.0] * 20, 10.0)
    stalled = _window([1.0] * 4 + [5.0] + [1.0] * 20, 10.0)
    assert stalled.rate() < steady.rate()
    assert stalled.percentile(90) > steady.percentile(90)


def test_a_job_ending_after_the_deadline_counts():
    w = _window([4.0, 4.0, 4.0, 4.0], 10.0)
    assert len(w.jobs) == 3 and w.seconds == 12.0
    assert w.rate() == 30 / 12.0


def test_percentile_nearest_rank():
    w = Window(0.0, [Job(0, t, 1) for t in range(1, 11)])
    assert w.percentile(90) == 9 and w.percentile(100) == 10 and w.percentile(50) == 5


def test_device_time_a_keyframe_over_all_the_window():
    from conftest import BENCH
    from harness.cell import load_module
    import os
    reader = load_module(os.path.join(BENCH, "metrics", "removert_device_ms_per_keyframe.py"))
    w = Window(0.0, [Job(0.0, 1.0, 96), Job(1.0, 2.5, 96)], device_s=0.384)
    assert w.units == 192 and reader.read_window(w) == 2.0

"""The card's time a keyframe costs (ms, profiler): the union of the
device's operations over the whole window, over the keyframes of all its
jobs.  Nothing where the window was not profiled (a run on the CPU)."""


def read_window(window):
    return None if window.device_s is None else 1e3 * window.device_s / window.units

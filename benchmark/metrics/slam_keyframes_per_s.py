"""Keyframes of all the window's jobs over all its time (host clock)."""


def read_window(window):
    return window.rate()

"""Whole-window statistics of the end-to-end metrics."""


def rate(work, seconds):
    """Work per second over the window."""
    return work / seconds


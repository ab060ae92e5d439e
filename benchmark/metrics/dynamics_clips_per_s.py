"""Clips trained in the window over the window's time (``train_loop``)."""


def read(e2e):
    return e2e.get("clips_per_s")

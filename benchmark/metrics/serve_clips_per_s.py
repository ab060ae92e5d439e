"""Clips of the windows whose results the stream returned in the window,
over the window's time (``stream_closed``)."""


def read(e2e):
    return e2e.get("clips_per_s")

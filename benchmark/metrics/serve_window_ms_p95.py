"""95th percentile over every served window of the time from its
``submit`` to the return of its results, ms (``stream_closed``)."""


def read(e2e):
    return e2e.get("window_ms_p95")

"""Share of the traced window, %, in which no operation ran on the device
(the complement of the union of the device's operation intervals)."""
from benchmark.trace import busy_ns


def read(rec):
    if not rec.get("window_ns"):
        return None
    return 100.0 * (1.0 - busy_ns(rec) / rec["window_ns"])

"""K1's share of its roofline, %: points read and the grid written once,
over the device time of K1's kernel."""
from benchmark.trace import device_ns
from benchmark.work import k1_bound_s


def read(rec):
    calls = rec.get("k1_calls") or []
    ns = device_ns(rec, lambda n: "voxelize_kernel" in n)
    if not calls or not ns:
        return None
    return 100.0 * sum(k1_bound_s(f, n, g, b) for f, n, g, b in calls) / (
        ns / 1e9)

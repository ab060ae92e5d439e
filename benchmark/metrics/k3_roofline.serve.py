"""K3's share of its roofline, %: the sum of each call's bound from its
operand shapes (x, w, b read once, y written once, its FLOPs at the bf16
peak) over the device time of K3's kernel."""
from benchmark.trace import device_ns
from benchmark.work import k3_bound_s


def read(rec):
    calls = rec.get("k3_calls") or []
    ns = device_ns(rec, lambda n: "conv3d_kernel" in n)
    if not calls or not ns:
        return None
    return 100.0 * sum(k3_bound_s(x, w) for x, w in calls) / (ns / 1e9)

"""K2's share of its roofline, %: the sum of each call's bound (forward and
backward; the keypoints and the grid read once, the occupied voxels'
operations) over the device time of K2's kernels."""
from benchmark.trace import device_ns
from benchmark.work import k2_bound_s


def read(rec):
    calls = rec.get("k2_calls") or []
    ns = device_ns(rec, lambda n: n.startswith("chamfer_") or
                   "chamfer_fwd_kernel" in n or "chamfer_bwd_kernel" in n)
    if not calls or not ns:
        return None
    bound = sum(k2_bound_s(m, k, g, b, n, False) + k2_bound_s(m, k, g, b, n,
                                                              True)
                for m, k, g, b, n in calls)
    return 100.0 * bound / (ns / 1e9)

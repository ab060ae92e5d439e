"""Device operations a clip launched by the VRNN: those launched inside
its encode range, and those of its backward (launched by autograd's
device thread)."""
from benchmark.trace import in_ranges, range_list


def read(rec):
    spans = range_list(rec, "vrnn_encode")
    if not spans or not rec.get("clips"):
        return None
    main = rec["main_thread"]
    n = sum(1 for k in rec["kernels"] if k[3] is not None and
            (k[3] != main or in_ranges(k[4], spans)))
    return n / rec["clips"]

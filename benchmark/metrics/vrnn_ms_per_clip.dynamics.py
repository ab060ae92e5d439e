"""ms a clip in the VRNN (``HSVRNNBVH.encode``): the host time of its
forward range plus the device time of the backward's kernels (launched by
autograd's device thread; the frozen detector takes no backward)."""
from benchmark.trace import range_list


def read(rec):
    spans = range_list(rec, "vrnn_encode")
    if not spans or not rec.get("clips"):
        return None
    fwd = sum(e - s for s, e in spans)
    main = rec["main_thread"]
    bwd = sum(k[2] for k in rec["kernels"]
              if k[3] is not None and k[3] != main)
    return (fwd + bwd) / 1e6 / rec["clips"]

"""The step's share of the card's dense bf16 peak, %: the useful FLOPs of a
clip on this cell's path (``benchmark/work.py``) times the clips of the
traced window, over the window's time and 989 TFLOP/s."""
from benchmark.work import PEAK_BF16_OPS_PER_S


def read(rec):
    if not rec.get("clips") or not rec.get("window_ns"):
        return None
    return 100.0 * rec["clips"] * rec["flops_per_clip"] / (
        rec["window_ns"] / 1e9) / PEAK_BF16_OPS_PER_S

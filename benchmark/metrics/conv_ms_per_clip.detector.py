"""Device ms a clip of the library's convolution kernels (cuDNN forward,
data-gradient and weight-gradient kernels and their layout transforms;
not the port's own K3), by the profiler's kernel names."""
from benchmark.trace import device_ns

CONV = ("conv", "Conv", "xmma", "implicit_gemm", "dgrad", "wgrad", "fprop",
        "cudnn", "nchwToNhwc", "nhwcToNchw")


def is_conv(name):
    return any(c in name for c in CONV) and "conv3d_kernel" not in name


def read(rec):
    ns = device_ns(rec, is_conv)
    if not ns or not rec.get("clips"):
        return None
    return ns / 1e6 / rec["clips"]

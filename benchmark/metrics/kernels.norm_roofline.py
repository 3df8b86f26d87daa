"""The fused norm's share of its roofline: the least time of its bytes
(the configuration's ``norm_shapes``, each forward reading x and writing
y, each backward reading x and dy and writing dx, once, at 3.35 TB/s)
over the device time of its kernels (``csrc/fused_norm.cu``: the
forward, the backward and the backward's parameter sums, by name) in
the same profiled steps, in percent."""

from benchmark.counts.norm_bytes import step_bytes
from benchmark.counts.peaks import HBM_BYTES_PER_S

KERNELS = ("::fwd_kernel<", "::bwd_kernel<", "::bwd_params_kernel")


def read(run):
    profile = run.window.profile
    shapes = run.counts.get("norm_shapes")
    if profile is None or not shapes:
        return None
    ms = sum(t for name, t in profile.device_ms.items()
             if any(k in name for k in KERNELS))
    if not ms:
        return None
    least_ms = (1e3 * step_bytes(shapes, run.counts["norm_itemsize"])
                / HBM_BYTES_PER_S * profile.steps)
    return 100.0 * least_ms / ms

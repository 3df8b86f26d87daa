"""Device time a profiled step of the convolution and matrix-product
kernels (cuDNN's and cuBLAS's, by the name patterns below), summed. The
library's side streams overlap the main one, so the sum can exceed the
step."""

PATTERNS = ("conv", "gemm", "xmma", "cutlass", "cudnn", "wgrad", "dgrad",
            "fprop")


def read(run):
    profile = run.window.profile
    if profile is None:
        return None
    ms = sum(t for name, t in profile.device_ms.items()
             if any(p in name.lower() for p in PATTERNS))
    return ms / profile.steps if ms else None

"""The whole step's share of the card's peak: the configuration's
``flops_per_step`` times the profiled steps, over the profiled wall time,
over the peak of the configuration's precision (bfloat16: 989 TFLOP/s;
float32 outside the tensor cores: 67 TFLOP/s), in percent."""

from benchmark.counts.peaks import FLOPS_PER_S


def read(run):
    profile = run.window.profile
    counts = run.counts
    if profile is None or not counts.get("flops_per_step"):
        return None
    rate = counts["flops_per_step"] * profile.steps / profile.window_s
    return 100.0 * rate / FLOPS_PER_S[counts["precision"]]

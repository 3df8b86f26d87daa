"""The fused norm's layout copies a profiled step: the change of the
program's ``group_norm_act.layout_copies`` counter (an input or incoming
gradient not in ``channels_last`` memory, copied before the kernel) over
the profiled steps, over those steps."""

from benchmark.harness.program_trace import count_per_step


def read(run):
    return count_per_step(run, "group_norm_act.layout_copies")

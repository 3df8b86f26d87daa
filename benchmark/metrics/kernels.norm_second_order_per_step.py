"""The fused norm's second-order launches a profiled step: the change of
the program's ``fused_norm._launch_second_order.launches`` counter (the
kernel that takes the gradient penalty's outer gradient through the
backward of a fused GroupNorm + activation, one a norm of D at the
interpolates) over the profiled steps, over those steps. None where the
program has no such counter."""

from benchmark.harness.program_trace import count_per_step


def read(run):
    return count_per_step(run, "fused_norm._launch_second_order.launches")

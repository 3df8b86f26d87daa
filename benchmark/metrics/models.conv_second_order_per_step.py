"""The convolutions' second orders a profiled step: the change of the
program's ``conv.second_order`` counter (a run of the rule that takes the
gradient penalty's double backward through cuDNN's weight- and
data-gradient calls, one a convolution between the interpolates and
D's features) over the profiled steps, over those steps. None where the
program has no such counter."""

from benchmark.harness.program_trace import count_per_step


def read(run):
    return count_per_step(run, "conv.second_order")

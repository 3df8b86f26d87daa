"""The dilated convolutions' second orders a profiled step: the change of
the program's ``conv.dilated_second_order`` counter (the runs of the
convolution rule's second order at a layer of dilation above 1, such as
CSRNet's backend, on cuDNN's weight- and data-gradient calls) over the
profiled steps, over those steps. None where the program has no such
counter."""

from benchmark.harness.program_trace import count_per_step


def read(run):
    return count_per_step(run, "conv.dilated_second_order")

"""Host ms a profiled step inside the program's input spans
(``input.draws``, the patch draws; ``input.copy``, their pinned copy to
the card; ``input.sample``, the three sampler launches), from the host
clock the program keeps for each span."""

from benchmark.harness.program_trace import host_ms_per_step


def read(run):
    return host_ms_per_step(run, "input.")

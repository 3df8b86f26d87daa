"""Stream-wall ms a profiled step under the program's ``step.g.forward``
and ``step.g.backward`` spans: G's loss against the updated D and its
gradient. The stream's wall time between the timing events the program
records as the span opens and closes
(``srgan_tpu_torch/utils/trace.py``), idle moments included: the phase's
device time only in a device-bound cell."""

from benchmark.harness.program_trace import device_ms_per_step


def read(run):
    return device_ms_per_step(run, ["step.g.forward", "step.g.backward"])

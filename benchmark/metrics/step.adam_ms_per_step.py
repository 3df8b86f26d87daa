"""Stream-wall ms a profiled step under the program's three update spans
(``step.d.adam``, ``step.g.adam``, ``step.dnn.adam``): gradient
averaging, the clip and Adam. The stream's wall time between the timing
events the program records as the span opens and closes
(``srgan_tpu_torch/utils/trace.py``), idle moments included: the phase's
device time only in a device-bound cell."""

from benchmark.harness.program_trace import device_ms_per_step


def read(run):
    return device_ms_per_step(run, ["step.d.adam", "step.g.adam",
                                    "step.dnn.adam"])

"""Stream-wall ms a profiled step under the program's
``step.d.backward`` span: D's parameter gradient of its total loss,
where the penalty's second order (the double backward) runs. The
stream's wall time between the timing events the program records as the
span opens and closes (``srgan_tpu_torch/utils/trace.py``), idle moments
included: the phase's device time only in a device-bound cell."""

from benchmark.harness.program_trace import device_ms_per_step


def read(run):
    return device_ms_per_step(run, ["step.d.backward"])

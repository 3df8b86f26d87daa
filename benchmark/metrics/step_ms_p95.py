"""The 95th percentile of the times of every step in the window: the
gaps between the CUDA events recorded on the step's stream after
consecutive steps (the first from the event recorded as the window
opened), read once the window has closed."""

from benchmark.harness.spec import percentile, step_gaps_ms


def read(run):
    if not run.window.step_ms:
        return None
    return percentile(step_gaps_ms(run.window.step_ms), 95)

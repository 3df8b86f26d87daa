"""The experiment loop's host time a step: the host clock around each
``Experiment._step`` call, averaged over the window. Under back-pressure
from the launch queue it reads close to the step time."""

import statistics


def read(run):
    spans = run.window.spans.get("step")
    return statistics.fmean(spans) if spans else None

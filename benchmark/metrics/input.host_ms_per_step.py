"""The input layer's host time a step: the host clock around the loop's
``next(batches)`` (the epoch iterators of ``epoch_batch_iterators``),
averaged over the window."""

import statistics


def read(run):
    spans = run.window.spans.get("input")
    return statistics.fmean(spans) if spans else None

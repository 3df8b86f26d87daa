"""Labeled images trained a second: the batch times the steps completed
in the window, over the window's wall time, which ends on
``torch.cuda.synchronize()``."""


def read(run):
    window = run.window
    if not window.steps:
        return None
    return run.settings.batch_size * window.steps / window.seconds

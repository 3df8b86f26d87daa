"""From the process's start to the window's first step: imports, the
kernels' load (their build on a checkout's first run), the data made on
the card, the models, the optimizer state, the checked and the warm-up
steps."""


def read(run):
    return run.setup_s

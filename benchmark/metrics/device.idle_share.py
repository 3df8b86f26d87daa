"""The share of the profiled wall time in which no operation ran on the
card: 100 × (1 − the union of the device's busy intervals / the wall
time)."""


def read(run):
    profile = run.window.profile
    if profile is None:
        return None
    return 100.0 * (1.0 - profile.busy_s / profile.window_s)

"""Share of the traced window in which no device operation ran, in %:
one less the union of the operations' busy intervals (the campaigns run
on a side stream, so a sum of kernel times would count overlaps twice)."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s())

"""Device operations the profiler recorded in the window (kernels,
copies and sets, warm-ups and evaluations included) per round completed
in it."""


def read(run):
    rounds = sum(c["rounds"] for c in run.calls)
    if run.trace is None or not run.trace.device or not rounds:
        return None
    return len(run.trace.device) / rounds

"""Share of the window spent capturing CUDA graphs: the campaigns' own
capture seconds (``CampaignResult.graphs["capture_s"]``) over the window's
wall seconds, in %."""


def read(run):
    total = sum(c["capture_s"] for c in run.calls)
    return 100.0 * total / run.window_s if total > 0 else None

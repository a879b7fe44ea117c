"""Mean wall ms of the window's evaluating rounds (the round's training,
Step 4 and the test forward), from the campaigns' own CUDA events on the
rounds' stream (``CampaignResult.round_ms``)."""
import numpy as np


def read(run):
    ms = [c["round_ms"][c["do_eval"]] for c in run.calls
          if len(c["round_ms"]) == len(c["do_eval"])]
    ms = np.concatenate(ms) if ms else np.zeros(0)
    ms = ms[np.isfinite(ms)]
    return float(ms.mean()) if ms.size else None

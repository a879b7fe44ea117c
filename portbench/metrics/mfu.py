"""Model FLOP utilisation of the window, in %: the useful FLOPs of its
campaigns (yardstick: the forwards and backwards of the schedule's
executed client steps, the fixed targets, Step 4 and the test forwards;
no padded slot, masked step, warm-up or recomputation) over the window's
seconds times the peak of the configuration's precision."""


def read(run):
    if not run.work.flops:
        return None
    return 100.0 * run.work.flops / (run.window_s * run.peak)

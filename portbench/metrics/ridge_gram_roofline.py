"""The Step-4 Gram kernel's share of its roofline, in %: the least time of
the Grams the window's evaluations need (each lane's eight (OᵀO, OᵀZ)
pairs over all client samples; operations at the 3xTF32 rate of
float32-accurate products, bytes at the HBM peak, whichever bounds) over
the device time of the Gram kernel in the trace."""
from portbench import yardstick

NAMES = ("gram_tf32_kernel",)


def read(run):
    if run.trace is None:
        return None
    ns = sum(d for name, _, d in run.trace.device
             if any(n in name for n in NAMES))
    if not ns or not run.work.gram_ops:
        return None
    return 100.0 * yardstick.least_gram_s(run.work) / (ns / 1e9)

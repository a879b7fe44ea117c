"""The mutual-KL kernels' share of their roofline, in %: the least time of
the KL work the window's schedules need (each selected client's executed
steps of B rows, forward and backward, both phases; bytes at the HBM
peak) over the device time of the KL kernels in the trace.  Kernels are
matched by name until the program names its KL ranges."""
from portbench import yardstick

NAMES = ("kl_rows_kernel", "kl_rows_online_kernel", "kl_grad_kernel",
         "kl_grad_online_kernel")


def read(run):
    if run.trace is None:
        return None
    ns = sum(d for name, _, d in run.trace.device
             if any(n in name for n in NAMES))
    if not ns or not run.work.kl_bytes:
        return None
    return 100.0 * yardstick.least_kl_s(run.work) / (ns / 1e9)

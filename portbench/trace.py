"""The traced window: ``torch.profiler`` over the host and the card, with
the card kept idle for ``QUIET_S`` at both edges (without them a window now
and then came back short of its first device events: the profiler drops
events whose converted time falls outside it), the harness's spans around
the program's layers, and the reduction of the trace to what the metric
readers take: device operations, the union of their busy intervals, and
idle gaps labelled by what the host was doing."""
from __future__ import annotations

import bisect
import contextlib
import functools
import importlib
import re
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

QUIET_S = 0.1
WINDOW = "portbench.window"
# the program's layers that the traced run wraps in spans of its own:
# (module, function); a name the program no longer has is skipped
SPANS = (("repro_torch.launch.campaign", "plan_schedule"),
         ("repro_torch.launch.campaign", "_initial_state"),
         ("repro_torch.launch.campaign", "_run_rounds_scan"),
         ("repro_torch.launch.campaign", "_capture"),
         ("repro_torch.launch.campaign", "_host_fetch"),
         ("repro_torch.core.engine", "build_round_fn"),
         ("repro_torch.core.engine", "build_eval_fn"))
SHORT_GAP_NS = 100_000     # gaps below 0.1 ms are summed, not labelled


@dataclass
class Trace:
    """Device operations (name, start ns, duration ns), the window's span
    in the trace's clock, and the idle time by host label."""
    device: List[Tuple[str, int, int]]
    window: Tuple[int, int]
    idle_by_label: Dict[str, float]

    def busy_s(self) -> float:
        """Seconds inside the window in which any device operation ran."""
        t0, t1 = self.window
        return sum(max(0, min(e, t1) - max(s, t0))
                   for s, e in union(self.device)) / 1e9

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9


def union(device) -> List[Tuple[int, int]]:
    """Merged [start, end) intervals of the device operations, in ns: the
    card is busy where any operation runs, whatever stream it is on."""
    out: List[List[int]] = []
    for s, e in sorted((s, s + d) for _, s, d in device):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def kernel_name(name: str) -> str:
    """A readable name of a device operation: the identifier of a mangled
    kernel that ends in "kernel", else the name cut at 80 characters."""
    if name.startswith("_Z"):
        for m in re.finditer(r"(\d+)([A-Za-z_]\w*)", name):
            n, rest = int(m.group(1)), m.group(2)
            if len(rest) >= n and rest[:n].endswith("kernel"):
                return rest[:n]
    return name[:80]


@contextlib.contextmanager
def spans(host_s: Dict[str, float]):
    """The program's layers in ``SPANS`` wrapped in spans of the harness,
    named ``<module tail>.<function>``: a profiler range (seen by a traced
    window) and the host seconds, summed into ``host_s``; restored
    after."""
    import torch
    saved = []
    for mod_name, fn_name in SPANS:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, fn_name, None)
        if fn is None:
            continue
        label = f"{mod_name.rsplit('.', 1)[-1]}.{fn_name}"

        def wrapped(*a, _fn=fn, _label=label, **k):
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function(_label):
                    return _fn(*a, **k)
            finally:
                host_s[_label] = (host_s.get(_label, 0.0)
                                  + time.perf_counter() - t0)
        saved.append((mod, fn_name, fn))
        setattr(mod, fn_name, functools.wraps(fn)(wrapped))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


class Window:
    """The measured window.  Untraced: the host clock between ``start`` and
    ``stop``, the card synchronised at both.  Traced: the same inside a
    started profiler, with ``QUIET_S`` of idle card at each edge and the
    window marked by a ``WINDOW`` range."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.prof = self.range = None

    def start(self) -> None:
        import torch
        torch.cuda.synchronize()
        if self.traced:
            from torch.profiler import ProfilerActivity, profile
            time.sleep(QUIET_S)
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
            torch.cuda.synchronize()
            time.sleep(QUIET_S)
            self.range = torch.profiler.record_function(WINDOW)
            self.range.__enter__()
        torch.cuda.reset_peak_memory_stats()
        self.t0 = time.perf_counter()

    def stop(self) -> float:
        """Closes the window; its wall seconds."""
        import torch
        torch.cuda.synchronize()
        wall = time.perf_counter() - self.t0
        if self.traced:
            self.range.__exit__(None, None, None)
            time.sleep(QUIET_S)
            self.prof.stop()
        return wall

    def trace(self) -> Optional[Trace]:
        if self.prof is None:
            return None
        return read(self.prof)


def read(prof) -> Trace:
    """The device operations and the labelled idle gaps of a stopped
    profiler's trace."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    device, host, window, main = [], [], None, None
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            # kernels, copies and sets; not the device-side shadows of the
            # host's ranges
            if not e.is_user_annotation():
                device.append((e.name(), e.start_ns(), e.duration_ns()))
            continue
        if e.name() == WINDOW:
            window, main = (e.start_ns(), e.end_ns()), e.start_thread_id()
        host.append((e.start_ns(), e.end_ns(), e.start_thread_id(),
                     e.name(), bool(e.is_user_annotation())))
    if window is None:
        raise RuntimeError("the trace holds no window range")
    host = sorted((h for h in host if h[2] == main), key=lambda h: h[0])
    return Trace(device=device, window=window,
                 idle_by_label=idle_by_label(union(device), window, host))


def idle_by_label(busy, window, host) -> Dict[str, float]:
    """Idle seconds of the window by what the host's main thread was doing
    at each gap's middle: the innermost harness or program span and the
    innermost operation inside it.  Gaps under ``SHORT_GAP_NS`` are summed
    as one entry."""
    edges = [window[0]] + [t for se in busy for t in se] + [window[1]]
    gaps = [(max(s, window[0]), min(e, window[1]))
            for s, e in zip(edges[0::2], edges[1::2])]
    out: Dict[str, float] = {}
    short = 0.0
    long_gaps = []
    for s, e in gaps:
        if e - s >= SHORT_GAP_NS:
            long_gaps.append((s + (e - s) // 2, (e - s) / 1e9))
        elif e > s:
            short += (e - s) / 1e9
    if short:
        out["gaps under 0.1 ms"] = short
    starts = [h[0] for h in host]
    stack: list = []
    i = 0
    for mid, secs in sorted(long_gaps):
        j = bisect.bisect_right(starts, mid)
        while i < j:
            while stack and stack[-1][1] <= host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] <= mid:
            stack.pop()
        spans_open = [h[3] for h in stack if h[4] and h[3] != WINDOW]
        label = spans_open[-1] if spans_open else "harness"
        if stack and not stack[-1][4]:
            label += ": " + stack[-1][3]
        out[label] = out.get(label, 0.0) + secs
    return out


def top_device_ops(device, k: int = 10) -> List[list]:
    """The ``k`` device operations by summed seconds."""
    total: Dict[str, float] = {}
    for name, _, dur in device:
        key = kernel_name(name)
        total[key] = total.get(key, 0.0) + dur / 1e9
    return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])
            [:k]]

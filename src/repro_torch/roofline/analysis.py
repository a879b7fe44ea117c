"""Three-term roofline of one rank's share of a step; twin of
``repro.roofline.analysis``:

    compute    = FLOPs of one rank / the card's peak FLOP/s
    memory     = bytes of one rank / the card's HBM bytes/s
    collective = Σ over the rank's collectives of the ring model's wire time

The JAX package reads all three from the compiled per-partition HLO.  Here
there is no HLO: the step runs eagerly (on ``meta`` tensors in the
dry-run, on real ones elsewhere) under two dispatch modes that see what
one rank does.

* ``CollectiveTrace`` records every c10d and functional collective with
  its payload bytes, elements and group (``c10d.allreduce_``,
  ``_c10d_functional.all_gather_into_tensor``, …).  Point-to-point sends
  are not collectives to it: the SFL round's ring shift
  (``launch.fl_dryrun.ring_shift``) records its ``collective-permute``
  itself (``record``).
* ``CostCounter`` counts one rank's FLOPs and bytes.  Under DTensor both
  modes let the DTensor run first (they return ``NotImplemented`` for a
  DTensor op) and see the local ops it runs, so a sharded matmul counts
  the local product, and replicated work counts in full on every rank, as
  JAX's per-partition HLO does.

Cards and links: ``launch.mesh``'s H100 constants.  A collective's group
rides NVLink when its ranks lie in one block of ``GPUS_PER_NODE``
consecutive ranks, else the inter-node links.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch.mesh import (GPUS_PER_NODE, INTER_NODE_BW, NVLINK_BW,
                                     PEAK_BF16, PEAK_BYTES, PEAK_FP32)


def link_bandwidth(ranks: Optional[Sequence[int]], group_size: int) -> float:
    """Bytes/s of one direction of the slowest link of a group: NVLink when
    its ranks lie in one node's block of ``GPUS_PER_NODE`` consecutive
    ranks (``ranks`` None: ranks 0..group_size − 1), else the inter-node
    links."""
    if ranks is None:
        ranks = range(max(int(group_size), 1))
    nodes = {int(r) // GPUS_PER_NODE for r in ranks}
    return NVLINK_BW if len(nodes) <= 1 else INTER_NODE_BW


@dataclass
class CollectiveOp:
    kind: str
    result_bytes: int
    group_size: int
    # element count of the payload, independent of its dtype: the wire
    # accounting of a CommQuant format multiplies it by the format's width
    result_elems: int = 0
    ranks: Optional[Tuple[int, ...]] = None
    # identical collectives this entry stands for (a count extrapolated
    # in the scan length, ``launch.dryrun.count_step``)
    count: int = 1

    def wire_time(self, link_bw: float) -> float:
        """Ring-model wire seconds of one rank over links of ``link_bw``
        bytes/s (the reference's formulas)."""
        n, s = self.result_bytes, max(self.group_size, 2)
        frac = (s - 1) / s
        if self.kind == "all-reduce":
            return 2 * n * frac / link_bw
        if self.kind == "all-gather":          # result = gathered
            return n * frac / link_bw
        if self.kind == "reduce-scatter":      # result = scattered shard
            return n * (s - 1) / link_bw
        if self.kind == "all-to-all":
            return n * frac / link_bw
        return n / link_bw                     # collective-permute

    @property
    def wire_seconds(self) -> float:
        return self.wire_time(link_bandwidth(self.ranks, self.group_size))


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

_ACTIVE: List["CollectiveTrace"] = []

# c10d op -> collective kind; the in-place ops' result is their first
# tensor argument(s)
_C10D = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast_": "broadcast",
    "scatter_": "scatter",
}
_FUNCTIONAL = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _group_ranks(group) -> Tuple[int, ...]:
    import torch.distributed as dist
    return tuple(dist.get_process_group_ranks(group))


def _c10d_group(args) -> Optional[Tuple[int, ...]]:
    import torch.distributed as dist
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return _group_ranks(dist.ProcessGroup.unbox(a))
            except RuntimeError:       # a ReduceOp, not a process group
                continue
    return None


def _functional_group(args) -> Optional[Tuple[int, ...]]:
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in reversed(args):
        if isinstance(a, str):
            try:
                return _group_ranks(_resolve_process_group(a))
            except (RuntimeError, ValueError):
                continue
    return None


def _payload(tensors: List[torch.Tensor]) -> Tuple[int, int]:
    return (sum(t.numel() * t.element_size() for t in tensors),
            sum(t.numel() for t in tensors))


def record(kind: str, tensor: torch.Tensor, group=None) -> None:
    """Record a collective of ``kind`` carrying ``tensor`` over ``group``
    (None: the default group) in every active ``CollectiveTrace``: for the
    patterns the traces cannot see, such as the point-to-point ring shift
    that stands for a ``collective-permute``."""
    if not _ACTIVE:
        return
    import torch.distributed as dist
    ranks = _group_ranks(group if group is not None
                         else dist.group.WORLD)
    nbytes, nelems = _payload([tensor])
    for tr in _ACTIVE:
        tr.ops.append(CollectiveOp(kind, nbytes, len(ranks), nelems, ranks))


_CLASSES: Dict[str, type] = {}


def _cls(name: str) -> type:
    """DTensor and FakeTensor, imported once (a dispatch mode asks for them
    at every op)."""
    if not _CLASSES:
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        _CLASSES.update(DTensor=DTensor, FakeTensor=FakeTensor)
    return _CLASSES[name]


def _is_dtensor_op(types) -> bool:
    dt = _cls("DTensor")
    return any(t is not torch.Tensor and issubclass(t, dt) for t in types)


# per op overload: (namespace, op name), looked up once
_OP_NAMES: Dict[object, Tuple[str, str]] = {}


def _op_name(func) -> Tuple[str, str]:
    got = _OP_NAMES.get(func)
    if got is None:
        ns, _, name = func._schema.name.partition("::")
        got = _OP_NAMES[func] = (ns, name)
    return got


class CollectiveTrace(TorchDispatchMode):
    """Records the collectives run under it (``ops``: ``CollectiveOp``s in
    call order).  ``counts``, ``collective_bytes`` and ``collective_s``
    sum them."""

    def __init__(self):
        super().__init__()
        self.ops: List[CollectiveOp] = []
        self.last_dtensor_op = None     # what a stuck DTensor step was in

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _is_dtensor_op(types):
            self.last_dtensor_op = str(func)
            return NotImplemented       # let DTensor lower to its collectives
        out = func(*args, **kwargs)
        self._collective(func, args, out)
        return out

    def _collective(self, func, args, out) -> None:
        ns, name = _op_name(func)
        if ns == "aten":
            return
        if ns == "c10d" and name in _C10D:
            kind = _C10D[name]
            nbytes, nelems = _payload(_tensors(args[0]))
            ranks = _c10d_group(args)
        elif ns == "_c10d_functional" and name in _FUNCTIONAL:
            kind = _FUNCTIONAL[name]
            nbytes, nelems = _payload(_tensors(out))
            ranks = _functional_group(args)
        else:
            return
        size = len(ranks) if ranks is not None else 1
        self.ops.append(CollectiveOp(kind, nbytes, size, nelems, ranks))

    @property
    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for c in self.ops:
            out[c.kind] = out.get(c.kind, 0) + c.count
        return out

    @property
    def collective_bytes(self) -> float:
        return float(sum(c.result_bytes * c.count for c in self.ops))

    @property
    def collective_s(self) -> float:
        return float(sum(c.wire_seconds * c.count for c in self.ops))


# ---------------------------------------------------------------------------
# FLOPs and bytes
# ---------------------------------------------------------------------------

def _is_fake(tensors) -> bool:
    fake = _cls("FakeTensor")
    return any(isinstance(t, fake) for t in tensors)


class CostCounter(CollectiveTrace):
    """One rank's work under it: ``flops``, ``bytes`` and the peak of the
    tensors it made that were alive at once (``peak_bytes``), and, as a
    ``CollectiveTrace``, its collectives (one dispatch mode for both: each
    mode costs every op a trip through Python).

    * FLOPs are ``torch.utils.flop_counter``'s count of each local op
      (matrix products, convolutions and attention; elementwise work counts
      nothing), on the local shapes of a DTensor program.
    * Bytes are each op's inputs read once and outputs written once, op by
      op, views and allocations excluded: an upper bound of what a fused
      program moves, not XLA's post-fusion "bytes accessed".
    * ``peak_bytes``: the most bytes of op outputs alive at once (views
      excluded), the counterpart of XLA's temp size; ``written``: the bytes
      of all of them, alive or not (what more ops can add to a peak).
    The ops DTensor runs on fake tensors to learn an output's layout are
    not counted, nor, with ``device`` (a device type), ops whose outputs
    lie on other devices: DTensor works out shard offsets with small index
    tensors on the host, which a ``meta`` step's own ops never make."""

    _SKIP = {"empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "detach", "lift_fresh", "alias"}

    def __init__(self, device: Optional[str] = None):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._registry = flop_registry
        self.device = device
        self.flops = 0
        self.bytes = 0
        self.written = 0
        self.live = 0
        self.peak_bytes = 0
        self.by_op: Dict[str, int] = {}
        self._ops: Dict[object, tuple] = {}

    def _free(self, n: int) -> None:
        self.live -= n

    def _info(self, func) -> tuple:
        """(counted, name, FLOP formula, moves bytes) of an op overload."""
        info = self._ops.get(func)
        if info is None:
            ns, name = _op_name(func)
            info = self._ops[func] = (
                ns == "aten", name, self._registry.get(func._overloadpacket),
                not (func.is_view or name in self._SKIP))
        return info

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _is_dtensor_op(types):
            self.last_dtensor_op = str(func)
            return NotImplemented
        out = func(*args, **kwargs)
        counted, name, fn, moves = self._info(func)
        if not counted:
            self._collective(func, args, out)
            return out
        outs = _tensors(out)
        if self.device is not None and not any(
                t.device.type == self.device for t in outs):
            return out
        ins = _tensors(list(args) + list(kwargs.values()))
        if _is_fake(ins) or _is_fake(outs):
            return out
        if fn is not None:
            f = int(fn(*args, **kwargs, out_val=out))
            self.flops += f
            self.by_op[name] = self.by_op.get(name, 0) + f
        if not moves:
            return out
        self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        for t in outs:
            n = t.numel() * t.element_size()
            self.written += n
            self.live += n
            weakref.finalize(t, self._free, n)
        self.peak_bytes = max(self.peak_bytes, self.live)
        return out


# ---------------------------------------------------------------------------
# The roofline
# ---------------------------------------------------------------------------

@dataclass
class MemoryStats:
    """One rank's bytes: its arguments, outputs and temporaries (the names
    of XLA's ``memory_analysis``)."""
    argument_size_in_bytes: float = 0.0
    output_size_in_bytes: float = 0.0
    temp_size_in_bytes: float = 0.0


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    collective_counts: Dict[str, int]
    model_flops: float = 0.0
    argument_bytes: float = 0.0
    temp_bytes: float = 0.0
    output_bytes: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    def to_dict(self) -> dict:
        d = dict(self.__dict__)
        d["dominant"] = self.dominant
        d["useful_flops_ratio"] = self.useful_flops_ratio
        return d


def peak_flops_for(dtype) -> float:
    """The card's peak FLOP/s for a step in ``dtype``: bf16 on the tensor
    cores, f32 on the CUDA cores (the port keeps TF32 off)."""
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return PEAK_BF16 if dt in (torch.bfloat16, torch.float16) else PEAK_FP32


def analyze(arch: str, shape: str, mesh_name: str, chips: int,
            cost: Dict[str, float], colls: Sequence[CollectiveOp],
            model_flops: float = 0.0, memory_stats=None, *,
            peak_flops: float = PEAK_BF16, mem_bw: float = PEAK_BYTES,
            link_bw: Optional[float] = None) -> Roofline:
    """The roofline of one rank: ``cost`` {"flops", "bytes accessed"} (a
    ``CostCounter``'s), ``colls`` its collectives (a ``CollectiveTrace``'s
    ``ops``).  ``link_bw`` puts every collective on links of that rate
    instead of each group's own (``link_bandwidth``)."""
    coll_bytes = float(sum(c.result_bytes * c.count for c in colls))
    coll_s = float(sum((c.wire_seconds if link_bw is None
                        else c.wire_time(link_bw)) * c.count for c in colls))
    counts: Dict[str, int] = {}
    for c in colls:
        counts[c.kind] = counts.get(c.kind, 0) + c.count
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    r = Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_device=flops, bytes_per_device=byts,
        collective_bytes=coll_bytes,
        compute_s=flops / peak_flops,
        memory_s=byts / mem_bw,
        collective_s=coll_s,
        collective_counts=counts,
        model_flops=model_flops)
    if memory_stats is not None:
        r.argument_bytes = float(memory_stats.argument_size_in_bytes)
        r.temp_bytes = float(memory_stats.temp_size_in_bytes)
        r.output_bytes = float(memory_stats.output_size_in_bytes)
    return r


def model_flops_estimate(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference), N = active params,
    D = total tokens processed."""
    n = cfg.n_active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch

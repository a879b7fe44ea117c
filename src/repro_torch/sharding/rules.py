"""Sharding strategies the zoo needs and DTensor lacks; the counterpart of
what XLA's SPMD partitioner does on its own for the JAX package.

``install()`` registers them once per process (``launch.dryrun`` calls it
before a step; the tests call it on their gloo and fake worlds):

* ``aten.searchsorted.Tensor`` (the MoE dispatch's slot starts,
  ``models.moe.dispatch_slots``): the sorted sequence is replicated and the
  queries may stay sharded on any dim, the output following them.  A
  sharded sorted sequence is all-gathered first: the collective the
  reference's docstring names for the global dispatch
  (``repro.models.moe``), and one a ``CostCounter`` records.

Nothing is replicated quietly: a strategy lists the layouts it accepts
and DTensor inserts (and a ``CollectiveTrace`` sees) the redistributions
that reach them.
"""
from __future__ import annotations

_INSTALLED = [False]


def install() -> None:
    """Register the strategies with DTensor (idempotent)."""
    if _INSTALLED[0]:
        return
    import torch
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    aten = torch.ops.aten

    @register_sharding(aten.searchsorted.Tensor)
    def _searchsorted(sorted_sequence, queries, *args, **kwargs):
        # placements: [output], [sorted_sequence, queries, sorter]
        sorter = [None] if kwargs.get("sorter") is not None else []
        rep = Replicate()
        out = [([rep], [rep, rep] + [rep] * len(sorter))]
        if sorted_sequence.ndim == 1:
            # a 1-D sequence serves every query alike: the queries keep
            # their layout
            out += [([Shard(d)], [rep, Shard(d)] + [rep] * len(sorter))
                    for d in range(queries.ndim)]
        return out

    _INSTALLED[0] = True

"""The port's own random streams (``torch.Generator``; the port does not
reproduce JAX's threefry): the int8 uniforms of (seed, client shard) lie
apart from the run's batch-index stream and from every other shard's, as
the reference's ``fold_in(fold_in(key, salt), shard)`` streams do.  Torch's
CPU generator keeps only the low 32 bits of its seed: an offset above bit
32 once gave every shard, and the batch indices, the same stream."""
import torch

from repro_torch.core import engine
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

SEEDS, SHARDS = range(256), range(8)


def test_uniform_streams_are_distinct_and_apart_from_the_batch_streams():
    got = {(s, sh): engine.uniform_generator(s, sh).initial_seed()
           for s in SEEDS for sh in SHARDS}
    assert len(set(got.values())) == len(got)
    # a run's batch indices come from torch.Generator().manual_seed(seed):
    # no uniform stream starts where the batch stream of a seed < 2^20 does
    assert min(got.values()) >= 2 ** 20
    assert all(v < 2 ** 32 for v in got.values())


def test_uniform_draws_differ_from_the_batch_draws_and_across_shards():
    for s in (0, 1, 7):
        batch = torch.rand(64, generator=torch.Generator().manual_seed(s))
        shards = [torch.rand(64, generator=engine.uniform_generator(s, sh))
                  for sh in range(4)]
        assert not any(torch.equal(batch, u) for u in shards)
        assert all(not torch.equal(shards[a], shards[b])
                   for a in range(4) for b in range(a))
        # the same (seed, shard) draws the same stream again
        assert torch.equal(shards[1], torch.rand(
            64, generator=engine.uniform_generator(s, 1)))

"""Helpers for the port's parity tests: replay the JAX package's RNG chain
so that the JAX round and the PyTorch round draw identical batches, and move
parameters between the two packages as numpy arrays."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro_torch.convert import params_from_numpy, params_to_numpy


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread while a test module runs (import it into
    the module to apply it).  The parity tests' tensors are small, and in
    the parallel test run torch's default pool, a thread a core in every
    worker, oversubscribes the cores: its threads wait on one another and
    slow the campaigns many times over (up to 70× on 8 cores, 6
    workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draw_round(key, n_phases: int, M: int, e_max: int, B: int, n: int):
    keys = jax.random.split(key, n_phases * M)

    def per_client(k):
        def step(k, _):
            k, sk = jax.random.split(k)
            return k, jax.random.randint(sk, (B,), 0, n)
        return jax.lax.scan(step, k, None, length=e_max)[1]

    return jax.vmap(per_client)(keys)


_round_indices = jax.jit(_draw_round, static_argnums=(1, 2, 3, 4, 5))


def replay_round_indices(key, n_phases: int, M: int, e_max: int, B: int,
                         n: int) -> np.ndarray:
    """Batch indices of one ``repro.core.engine.build_round_fn`` round:
    ``split(key, n_phases*M)`` gives each (phase, client) a key; each step
    does ``k, sk = split(k)`` and ``randint(sk, (B,), 0, n)``.  Returns
    (n_phases, M, e_max, B) int64 (the draw compiled once a shape: the
    same bits as the reference's)."""
    idx = _round_indices(key, n_phases, M, e_max, B, n)
    return np.asarray(idx, np.int64).reshape(n_phases, M, e_max, B)


class TrainerIndexReplay:
    """``index_source`` for the port's SplitMeTrainer that replays the JAX
    SplitMeTrainer: ``PRNGKey(seed)``, then per round
    ``key, sub = split(key)`` and the round's split chain from ``sub``.
    Call once per round, in order."""

    def __init__(self, seed: int, M: int, e_max: int, B: int, n: int,
                 n_phases: int = 2):
        self.key = jax.random.PRNGKey(seed)
        self.shape = (n_phases, M, e_max, B, n)
        self.calls = 0

    def __call__(self, round_idx: int) -> torch.Tensor:
        assert round_idx == self.calls, "rounds must be replayed in order"
        self.calls += 1
        self.key, sub = jax.random.split(self.key)
        return torch.from_numpy(replay_round_indices(sub, *self.shape))


def bf16_ulp(v) -> np.ndarray:
    """One bf16 unit in the last place at |v| (8 significant bits)."""
    mag = np.maximum(np.abs(np.asarray(v, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def jax_to_torch(layers, device="cpu"):
    return params_from_numpy(jax.device_get(layers), device=device)


def torch_to_np(layers):
    return params_to_numpy(layers)


def assert_params_close(port_layers, jax_layers, atol, rtol=0.0):
    ref = jax.device_get(jax_layers)
    got = params_to_numpy(port_layers)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        for k in ("w", "b"):
            np.testing.assert_allclose(g[k], np.asarray(r[k]), atol=atol,
                                       rtol=rtol)


class CampaignIndexReplay:
    """``index_source`` for the port's ``run_campaign`` that replays the JAX
    ``run_campaign``: per seed ``PRNGKey(seed)``, then per round
    ``key, sub = split(key)`` and the round's full-M split chain from
    ``sub`` over the round's E bucket.  Call in round order per seed."""

    def __init__(self, seeds, M: int, B: int, n: int, n_phases: int = 2):
        self.keys = [jax.random.PRNGKey(s) for s in seeds]
        self.rounds = [0] * len(seeds)
        self.shape = (n_phases, M)
        self.B, self.n = B, n

    def __call__(self, i: int, round_idx: int, e_max: int) -> torch.Tensor:
        assert round_idx == self.rounds[i], "rounds must be replayed in order"
        self.rounds[i] += 1
        self.keys[i], sub = jax.random.split(self.keys[i])
        return torch.from_numpy(replay_round_indices(
            sub, *self.shape, e_max, self.B, self.n))


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5, 6))
def _campaign_indices(seed_keys, rounds: int, n_phases: int, M: int,
                      e_max: int, B: int, n: int):
    def per_seed(key):
        def next_round(k, _):
            k, sub = jax.random.split(k)
            return k, sub
        subs = jax.lax.scan(next_round, key, None, length=rounds)[1]
        return jax.vmap(lambda sub: _draw_round(
            sub, n_phases, M, e_max, B, n))(subs)

    return jax.vmap(per_seed)(seed_keys)


class CampaignIndexDraws:
    """``index_source`` with the draws of ``CampaignIndexReplay`` made in one
    compiled call a campaign: every seed's round keys split up front
    (``PRNGKey(seed)``, ``key, sub = split(key)`` a round) and every round
    drawn at ``e_max`` steps, the largest E bucket; a round's draw at its
    own bucket is the prefix, as the reference's step keys are split one
    after another.  Callable in any order and again: a config sweep and its
    per-variant campaigns, which draw the same rounds at different E
    buckets, read one table."""

    def __init__(self, seeds, rounds: int, M: int, B: int, n: int,
                 e_max: int, n_phases: int = 2):
        keys = jax.numpy.stack([jax.random.PRNGKey(s) for s in seeds])
        self.e_max = e_max
        self.idx = np.asarray(_campaign_indices(
            keys, rounds, n_phases, M, e_max, B, n), np.int64).reshape(
            len(seeds), rounds, n_phases, M, e_max, B)

    def __call__(self, i: int, round_idx: int, e_max: int) -> torch.Tensor:
        assert e_max <= self.e_max, (e_max, self.e_max)
        return torch.from_numpy(self.idx[i, round_idx, :, :, :e_max])


# the reference's quantization salt (``repro.core.engine._QSALT``)
QSALT = 0x5157


def replay_round_uniforms(key, trained, shard: int = 0) -> np.ndarray:
    """The int8 uniforms of one ``repro.core.engine`` round: the round key's
    quantization stream ``fold_in(fold_in(key, QSALT), shard)`` (client
    shard ``shard`` of the sharded round; 0 for one device), split once per
    leaf of the payload in ``jax.tree.flatten`` order (dict keys sorted: a
    layer's ``"b"`` before its ``"w"``), ``uniform(k, leaf.shape)`` each.
    ``trained``: ``{param index: layers}`` of the trained params (arrays or
    shape-carrying numpy).  Returns them flat, f32, in that order (the
    port's ``quantcomm.tree_leaves`` order)."""
    leaves = jax.tree.leaves(trained)
    qkey = jax.random.fold_in(jax.random.fold_in(key, QSALT), shard)
    keys = jax.random.split(qkey, len(leaves))
    return np.concatenate([
        np.asarray(jax.random.uniform(k, np.shape(l), dtype=np.float32))
        .ravel() for k, l in zip(keys, leaves)])


class TrainerUniformReplay:
    """``uniform_source`` for the port's SplitMeTrainer that replays the
    JAX SplitMeTrainer's int8 draws: ``PRNGKey(seed)``, per round ``key,
    sub = split(key)``, then ``replay_round_uniforms(sub, trained)``.  Call
    once per round, in order."""

    def __init__(self, seed: int, trained):
        self.key = jax.random.PRNGKey(seed)
        self.trained = trained
        self.calls = 0

    def __call__(self, round_idx: int) -> torch.Tensor:
        assert round_idx == self.calls, "rounds must be replayed in order"
        self.calls += 1
        self.key, sub = jax.random.split(self.key)
        return torch.from_numpy(replay_round_uniforms(sub, self.trained))


class CampaignUniformReplay:
    """``uniform_source`` for the port's ``run_campaign`` that replays the
    JAX ``run_campaign``'s int8 draws: per seed ``PRNGKey(seed)``, per round
    ``key, sub = split(key)``, then ``replay_round_uniforms(sub, trained)``
    (one seed's trained params).  Call in round order per seed."""

    def __init__(self, seeds, trained):
        self.keys = [jax.random.PRNGKey(s) for s in seeds]
        self.rounds = [0] * len(seeds)
        self.trained = trained

    def __call__(self, i: int, round_idx: int) -> torch.Tensor:
        assert round_idx == self.rounds[i], "rounds must be replayed in order"
        self.rounds[i] += 1
        self.keys[i], sub = jax.random.split(self.keys[i])
        return torch.from_numpy(replay_round_uniforms(sub, self.trained))


def jax_initial_params(name: str, jcfg, seeds):
    """The JAX campaign's initial params of ``name`` on ``jcfg``
    (``PRNGKey(seed + init_key_offset)``), one numpy params tuple a seed:
    the port's ``run_campaign(params=)``."""
    from repro.core import engine as jengine
    jspec = jengine.make_spec(name, jcfg)
    init = jax.device_get(jax.vmap(jspec.init_fn)(jax.numpy.stack(
        [jax.random.PRNGKey(s + jspec.init_key_offset) for s in seeds])))
    return [tuple([{k: v[i] for k, v in layer.items()} for layer in half]
                  for half in init) for i in range(len(seeds))]

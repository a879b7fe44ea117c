"""The port's optimizers and schedules (``repro_torch.optim``) against the
JAX package's on the CPU.

Schedules are pure Python in both packages: exactly equal on a grid.  The
optimizers run on a tree stacked as the JAX zoo stacks its layers (per-
layer 1-D, 2-D and 3-D leaves on a leading layer axis, Zamba2's
(groups, group) axes, single leaves): the port holds one tensor a layer
and gets the stacking from ``stacks``.  The same gradients, drawn from a
numpy seed, go to both; params and state after 5 steps at ``TOL`` 1e-6
(f32 arithmetic in the same order but for the reductions' summation
order: a few ulp).  Adafactor's row/column statistics and its update clip
span the layers of a stacked leaf; a per-tensor Adafactor misses that by
far more than TOL, which the test shows.  The reference's own optimizer
tests (tests/test_optimizers.py, tests/test_schedules.py) are twinned.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro_torch.convert import _leaves
from repro_torch.optim import optimizers as opt
from repro_torch.optim import schedules as sched
from repro_torch.optim.optimizers import adafactor, adamw, leaf_groups, sgd

from torch_parity import one_torch_thread  # noqa: F401

TOL = 1e-6
STEPS = 5
L, G, GROUP = 3, 2, 2
STACKS = {"layers": (L,), "mamba": (G, GROUP)}


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def test_schedules_equal_the_reference_exactly():
    steps = list(range(0, 130)) + [500, 10 ** 6]
    for args in ((1.0, 10, 100), (3e-4, 0, 50), (0.5, 7, 7, 0.0),
                 (2e-3, 100, 30, 0.3)):
        f, g = sched.warmup_cosine(*args), jsched.warmup_cosine(*args)
        assert [f(s) for s in steps] == [g(s) for s in steps]
    assert [sched.constant(0.1)(s) for s in steps] == \
        [jsched.constant(0.1)(s) for s in steps]
    for T in (1, 10, 100, 1000):
        for E in (1, 4, 20):
            for B_ in (0.05, 0.1, 0.3, 2.0):
                for q in (None, [0.2] * 5, [0.1, 0.7]):
                    assert (sched.corollary2_rate(T, E, 1.5, B_, q)
                            == jsched.corollary2_rate(T, E, 1.5, B_, q))
            assert sched.splitme_rates(T, E) == jsched.splitme_rates(T, E)
    assert sched.corollary2_rate(0, 0, 1.0, 0.1) == \
        jsched.corollary2_rate(0, 0, 1.0, 0.1)


def test_warmup_cosine_shape():
    f = sched.warmup_cosine(1.0, warmup_steps=10, total_steps=100)
    assert f(0) < f(5) < f(9)
    assert abs(f(10) - 1.0) < 0.01
    assert f(50) < f(10)
    assert f(99) >= 0.1 * 0.99


def test_corollary2_ordering_and_sqrt_t_scaling():
    eta_c, eta_s = sched.splitme_rates(T=1000, E=10, L=1.0, b1=0.1, b2=0.3)
    assert eta_c > eta_s > 0
    e1 = sched.corollary2_rate(T=100, E=4, L=1.0, B=0.2)
    e2 = sched.corollary2_rate(T=400, E=4, L=1.0, B=0.2)
    assert abs(e1 / e2 - 2.0) < 1e-9
    with pytest.raises(AssertionError):
        sched.splitme_rates(T=10, E=1, b1=0.5, b2=0.2)


# ---------------------------------------------------------------------------
# the reference's optimizer tests, twinned
# ---------------------------------------------------------------------------

def _converges(factory, steps=200):
    init, update = factory
    target = torch.tensor([1.5, -2.0, 0.5])
    params = {"w": torch.zeros(3, requires_grad=True),
              "m": torch.zeros(4, 3, requires_grad=True)}
    state = init(params)
    step = torch.zeros((), dtype=torch.int32)

    def loss_fn():
        return (torch.sum((params["w"] - target) ** 2)
                + torch.sum(params["m"] ** 2))
    loss0 = loss_fn().item()
    for _ in range(steps):
        grads = dict(zip(params, torch.autograd.grad(loss_fn(),
                                                     list(params.values()))))
        state = update(params, grads, state, step)
        step = step + 1
    return loss_fn().item(), loss0


@pytest.mark.parametrize("factory", [sgd(0.05), sgd(0.02, momentum=0.9),
                                     adamw(0.05), adafactor(0.05)],
                         ids=["sgd", "sgd_momentum", "adamw", "adafactor"])
def test_optimizers_converge(factory):
    final, initial = _converges(factory)
    assert final < 0.05 * initial


def test_adafactor_state_is_factored():
    init, _ = adafactor(0.01)
    params = {"w": torch.zeros(64, 32), "b": torch.zeros(32)}
    state = init(params)
    assert state["w"]["vr"].shape == (64,)
    assert state["w"]["vc"].shape == (32,)
    assert state["b"]["v"].shape == (32,)
    n_adaf = sum(t.numel() for s in state.values() for t in s.values())
    n_adam = 2 * sum(p.numel() for p in params.values())
    assert n_adaf < 0.2 * n_adam


def test_adamw_bias_correction_first_step():
    init, update = adamw(1.0, b1=0.9, b2=0.999, eps=1e-12)
    params = {"w": torch.zeros(2)}
    g = {"w": torch.tensor([0.5, -0.5])}
    update(params, g, init(params), torch.zeros((), dtype=torch.int32))
    torch.testing.assert_close(params["w"], torch.tensor([-1.0, 1.0]),
                               atol=1e-5, rtol=0)


def test_get_optimizer_names():
    assert opt.get_optimizer("sgd", 0.1)[0]({"w": torch.zeros(2)})["w"] \
        .dtype == torch.float32          # momentum 0.9: a state
    with pytest.raises(ValueError):
        opt.get_optimizer("lion", 0.1)


# ---------------------------------------------------------------------------
# against the JAX optimizers on a stacked tree
# ---------------------------------------------------------------------------

def _tree(rng, scale=1.0):
    """A JAX-layout tree: per-layer 1-D / 2-D / 3-D leaves stacked on L,
    Zamba2-style (G, GROUP) leaves and single leaves of each rank."""
    n = lambda *s: (rng.normal(size=s) * scale).astype(np.float32)
    return {"layers": {"ln": n(L, 24), "w": n(L, 24, 16),
                       "experts": n(L, 4, 16, 8)},
            "mamba": {"ln": n(G, GROUP, 24), "w_in": n(G, GROUP, 24, 12)},
            "embed": n(40, 24), "ln_f": n(24), "bias": n(1)}


def _to_port(tree):
    """The JAX tree -> the port's {name: tensor}, one tensor a layer."""
    out = {}
    for path, leaf in _leaves(tree):
        dims = STACKS.get(path[0])
        if dims is None:
            out[".".join(path)] = torch.tensor(leaf)
            continue
        flat = leaf.reshape((-1,) + leaf.shape[len(dims):])
        for i, row in enumerate(flat):
            out[".".join((path[0], str(i)) + path[1:])] = torch.tensor(row)
    return out


def _to_jax_layout(named, like):
    out = {}
    for path, leaf in _leaves(like):
        dims = STACKS.get(path[0])
        if dims is None:
            val = named[".".join(path)].numpy()
        else:
            n = math.prod(dims)
            val = np.stack([named[".".join((path[0], str(i)) + path[1:])]
                            .numpy() for i in range(n)]).reshape(leaf.shape)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = val
    return out


def _close(got, want, what):
    for (pg, g), (pw, w) in zip(_leaves(got), _leaves(want)):
        assert pg == pw
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=TOL,
                                   atol=TOL, err_msg=f"{what} {pg}")


def _run(name, lr, stacks=STACKS):
    """STEPS steps of both packages on the same gradients: ((port params,
    port state), (JAX params, JAX state))."""
    rng = np.random.default_rng(0)
    jp = _tree(rng)
    grads = [_tree(rng, 0.1 * (k + 1)) for k in range(STEPS)]
    if name == "adafactor":
        jinit, jupdate = jopt.adafactor(lr)
        init, update = adafactor(lr, stacks=stacks)
    else:
        jinit, jupdate = jopt.get_optimizer(name, lr)
        init, update = opt.get_optimizer(name, lr)
    jparams = jax.tree.map(jnp.asarray, jp)
    jstate = jinit(jparams)
    params = _to_port(jp)
    state = init(params)
    for k, g in enumerate(grads):
        jparams, jstate = jax.jit(jupdate)(
            jparams, jax.tree.map(jnp.asarray, g), jstate,
            jnp.asarray(k, jnp.int32))
        state = update(params, _to_port(g), state,
                       torch.tensor(k, dtype=torch.int32))
    return (params, state), (jax.device_get(jparams), jax.device_get(jstate))


@pytest.mark.parametrize("name,lr", [("sgd", 0.05), ("adamw", 3e-2),
                                     ("adafactor", 1e-2)])
def test_optimizer_matches_jax_on_a_stacked_tree(name, lr):
    (params, state), (jparams, jstate) = _run(name, lr)
    _close(_to_jax_layout(params, jparams), jparams, "params")
    if name == "adafactor":
        # keyed by the JAX leaf, in its stacked shapes
        want = {".".join(p): s for p, s in _leaves(
            jstate, is_leaf=lambda v: isinstance(v, dict)
            and ("v" in v or "vr" in v))}
        assert set(state) == set(want)
        for leaf, s in want.items():
            for k, w in s.items():
                assert tuple(state[leaf][k].shape) == w.shape, (leaf, k)
                np.testing.assert_allclose(state[leaf][k].numpy(), w,
                                           rtol=TOL, atol=TOL)
        return
    if name == "adamw":
        for k in ("m", "v"):
            _close(_to_jax_layout(state[k], jparams), jstate[k], k)
    else:
        _close(_to_jax_layout(state, jparams), jstate, "momentum")


def test_adafactor_statistics_and_clip_span_the_stack():
    """A per-layer 1-D leaf stacked to (L, d) is a matrix to the
    reference: its vc averages over the layers and its clip takes the RMS
    over all of them.  The port's stacked Adafactor matches; one that
    factors each tensor alone does not."""
    (_, state), (jparams, jstate) = _run("adafactor", 1e-2)
    assert jstate["layers"]["ln"]["vr"].shape == (L,)
    assert jstate["layers"]["ln"]["vc"].shape == (24,)
    assert jstate["mamba"]["ln"]["vc"].shape == (G, 24)
    (alone, _), _ = _run("adafactor", 1e-2, stacks=None)
    got = _to_jax_layout(alone, jparams)
    err = np.abs(got["layers"]["ln"] - jparams["layers"]["ln"]).max()
    assert err > 100 * TOL, err


def test_leaf_groups():
    names = ["embed", "layers.1.w", "layers.0.w", "mamba.3.ln",
             "mamba.0.ln", "mamba.1.ln", "mamba.2.ln"]
    groups = leaf_groups(names, STACKS | {"layers": (2,)})
    assert groups == {"embed": ((), ["embed"]),
                      "layers.w": ((2,), ["layers.0.w", "layers.1.w"]),
                      "mamba.ln": ((2, 2), [f"mamba.{i}.ln"
                                            for i in range(4)])}
    with pytest.raises(ValueError, match="fill the stack"):
        leaf_groups(["layers.0.w", "layers.2.w"], {"layers": (3,)})

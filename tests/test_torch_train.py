"""Zoo training through the port against the JAX package on the CPU:
``lm_loss`` (a vision prefix, DeepSeek-V3's MTP head, the MoE aux term) and
``make_train_step`` on all ten reduced zoo configs (AdamW and momentum
SGD), Adafactor on reduced DeepSeek-V3, bf16 parameters, bf16 gradients
and the refusal of a model that routes a scan to its kernel.

The weights are the JAX package's (``model.init(PRNGKey(0))``) carried
across with ``convert.model_params_from_numpy``; tokens and frontend
embeddings come from seeded numpy generators; the JAX steps are the JAX
package's own ``make_train_step``.  No Pallas kernel lies on these paths:
the JAX models train on ``_sdpa`` and the plain scans, and so does the
port (``policy="reference"``).

Bounds, each with its reason:

* ``LOSS_TOL`` 1e-5 for an f32 loss of O(1-10) (measured <= 1.5e-6);
* ``GRAD_TOL`` 1e-5 of each leaf's max|g| for the gradients (the f32
  parity bound; measured <= 4.2e-6, Zamba2's ``w_in``);
* SGD (momentum 0.9) after ``STEPS`` steps: each element within
  ``SGD_TOL`` 1e-5 of its leaf's largest move max|p_T - p_0| (the update
  is lr x a sum of gradients, each within GRAD_TOL of its leaf's max) plus
  one f32 ulp of its value a step (p - lr m rounds to the ulp of p, up or
  down on a last-bit difference of m; the moves, ~3e-4, are small beside
  the weights);
* AdamW: after one step the moments m and v within ``MOMENT_TOL`` 1e-5
  of their leaf's max (they are linear and quadratic in the same g); after
  ``STEPS`` steps each parameter element within 2 lr x STEPS.  Adam's
  first steps are about -lr sign(g): where |g| is near eps = 1e-8 a 1e-7
  change of g moves an element's update by O(lr), so an element may sit up
  to 2 lr a step from JAX's, and the later gradients, taken there, carry
  that on (the moments after 3 steps part up to 2.3e-4 of their max,
  measured: InternVL2's ``embed``);
* Adafactor: the state at ``FACTOR_TOL`` 1e-5 of each leaf's max; the
  parameters at ``FACTOR_PARAM_TOL`` 1e-4 of their leaf's largest move
  plus SGD's f32 ulp a step.  An element's update is lr g / sqrt(v), and
  the factored v of a leaf's small rows and columns sits far below the
  leaf's largest g^2, so g's error of 1e-5 of the leaf's max|g| grows in
  u by max|g| / sqrt(v) (measured: 1.4e-5 of the move, the MTP block's
  router);
* bf16 parameters and bf16 gradients (AdamW): the losses at 1e-3, the
  rule of tests/test_torch_precision.py; each parameter element within
  AdamW's 2 lr x STEPS plus one bf16 ulp of its value (the bf16 update
  rounds to it; bf16 gradients flip the sign of more small elements).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models.transformer import build_model as jax_build_model
from repro.optim import optimizers as joptim
from repro.runtime.steps import lm_loss as jax_lm_loss
from repro.runtime.steps import make_train_step as jax_train_step
from repro_torch.configs.base import get_config
from repro_torch.convert import (_stack, layer_stacks,
                                 model_params_from_numpy,
                                 model_params_to_numpy, opt_state_from_numpy,
                                 opt_state_to_numpy)
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.mamba2_scan import ops as ssd_ops
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.models.transformer import build_model
from repro_torch.runtime import steps
from repro_torch.runtime.steps import lm_loss, make_train_step

from torch_parity import bf16_ulp, one_torch_thread  # noqa: F401

ARCHS = ("smollm-135m", "qwen3-14b", "granite-20b", "nemotron-4-15b",
         "internvl2-1b", "granite-moe-3b-a800m", "deepseek-v3-671b",
         "seamless-m4t-medium", "rwkv6-1.6b", "zamba2-2.7b")
B, S = 2, 16
LR = 3e-4              # make_train_step's default
STEPS = 3
LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
SGD_TOL = 1e-5
MOMENT_TOL = 1e-5
FACTOR_TOL = 1e-5
FACTOR_PARAM_TOL = 1e-4
BF16_TOL = 1e-3


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32)
                        if a.dtype == jnp.bfloat16 else np.asarray(a),
                        jax.device_get(tree))


def _batches(cfg, seed):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, S))
    jb, tb = {"tokens": jnp.asarray(tok)}, {"tokens": torch.from_numpy(tok)}
    if cfg.frontend:
        e = rng.normal(size=(B, cfg.frontend_positions, cfg.d_model))
        e = e.astype(np.float32)
        jb["embeds"] = jnp.asarray(e).astype(cfg.dtype)
        tb["embeds"] = torch.from_numpy(e).to(getattr(torch, cfg.dtype))
    return jb, tb


def _port_model(cfg, jparams, **kw):
    model = build_model(cfg, device="cpu", policy="reference", remat=False,
                        **kw)
    model.load_state_dict(model_params_from_numpy(cfg, _np_tree(jparams),
                                                  device="cpu"))
    return model


def _flat(tree):
    """{dotted path: numpy leaf} of a JAX-layout tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)] = np.asarray(leaf, np.float32)
    return out


def _jax_run(jm, jcfg, params, optimizer, batches, grad_dtype=None):
    """The JAX package's own train step, STEPS steps: (losses, params,
    opt state)."""
    _, train_step = jax_train_step(jm, optimizer=optimizer, lr=LR,
                                   grad_dtype=grad_dtype)
    opt = joptim.get_optimizer(optimizer, LR)[0](params)
    step = jnp.zeros((), jnp.int32)
    jstep = jax.jit(train_step)
    losses, first = [], None
    for jb in batches:
        params, opt, step, m = jstep(params, opt, step, jb)
        losses.append(float(m["loss"]))
        first = opt if first is None else first
    return losses, params, opt, first


def _port_run(model, optimizer, batches, grad_dtype=None):
    init_state, train_step = make_train_step(model, optimizer=optimizer,
                                             lr=LR, grad_dtype=grad_dtype)
    opt, step = init_state()
    losses, first = [], None
    for tb in batches:
        opt, step, m = train_step(opt, step, tb)
        losses.append(m["loss"].item())
        if first is None:
            first = opt_state_to_numpy(model.cfg, optimizer, opt)
    assert int(step) == len(batches)
    return losses, opt, first


def _run_both(arch, optimizer, cfg_fn=lambda c: c, grad_dtype=None):
    jcfg = cfg_fn(jax_get_config(arch).reduced())
    cfg = cfg_fn(get_config(arch).reduced())
    jm = jax_build_model(jcfg, remat=False)
    params = jm.init(jax.random.PRNGKey(0))
    model = _port_model(cfg, params)
    data = [_batches(cfg, 10 + i) for i in range(STEPS)]
    jl, jp, jo, jfirst = _jax_run(jm, jcfg, params, optimizer,
                                  [d[0] for d in data], grad_dtype)
    counters = (fa_ops.launches, wkv_ops.launches, ssd_ops.launches)
    tl, to, tfirst = _port_run(model, optimizer, [d[1] for d in data],
                               grad_dtype)
    assert counters == (fa_ops.launches, wkv_ops.launches, ssd_ops.launches)
    return dict(cfg=cfg, init=_flat(_np_tree(params)), jl=jl,
                jp=_flat(_np_tree(jp)), jo=jo, jfirst=jfirst, tl=tl,
                tp=_flat(model_params_to_numpy(model)), to=to,
                tfirst=tfirst, model=model)


# ---------------------------------------------------------------------------
# lm_loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["internvl2-1b", "deepseek-v3-671b",
                                  "granite-moe-3b-a800m"])
def test_lm_loss_matches_jax(arch):
    """A vision prefix (only the token positions count), the MTP t+2 term
    and the MoE aux term, on logits drawn from numpy."""
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    rng = np.random.default_rng(3)
    prefix = cfg.frontend_positions if cfg.family == "vlm" else 0
    logits = rng.normal(size=(B, prefix + S, cfg.vocab_size)) * 3
    tok = rng.integers(0, cfg.vocab_size, (B, S))
    extras = {"aux": np.float32(rng.uniform(0.5, 2.0))}
    if cfg.mtp:
        extras["mtp_logits"] = rng.normal(size=logits.shape) * 3
    jx = {k: jnp.asarray(v, jnp.float32) for k, v in extras.items()}
    tx = {k: torch.tensor(np.asarray(v, np.float32)) for k, v in
          extras.items()}
    want = jax_lm_loss(jcfg, jnp.asarray(logits, jnp.float32),
                       jnp.asarray(tok), jx)
    got = lm_loss(cfg, torch.tensor(logits, dtype=torch.float32),
                  torch.from_numpy(tok), tx)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)
    if cfg.mtp:   # the MTP term counts, with its weight
        plain = lm_loss(cfg, torch.tensor(logits, dtype=torch.float32),
                        torch.from_numpy(tok), {"aux": tx["aux"]})
        assert got.item() - plain.item() > 0.3
    assert steps.MTP_WEIGHT == 0.3 and steps.MOE_AUX_WEIGHT == 0.01


# ---------------------------------------------------------------------------
# loss and gradients, all ten configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch):
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jm = jax_build_model(jcfg, remat=False)
    params = jm.init(jax.random.PRNGKey(0))
    jb, tb = _batches(cfg, 7)

    def loss_fn(p):
        logits, extras = jm.forward(p, jb)
        return jax_lm_loss(jcfg, logits, jb["tokens"], extras)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    model = _port_model(cfg, params)
    for p in model.parameters():
        p.requires_grad_(True)
    logits, extras = model.forward(tb)
    loss = lm_loss(cfg, logits, tb["tokens"], extras)
    loss.backward()
    if cfg.family == "moe":
        assert extras["aux"].requires_grad
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=0,
                               atol=LOSS_TOL)
    got = _flat(model_params_to_numpy(model))   # shapes and names
    grads = _flat(_grad_tree(model))
    want = _flat(_np_tree(jgrads))
    assert set(grads) == set(want) == set(got)
    for name, w in want.items():
        scale = np.abs(w).max()
        err = np.abs(grads[name] - w).max()
        assert err <= GRAD_TOL * scale, (name, err, scale)


def _grad_tree(model):
    return _stack(model.cfg, [(n, p.grad if p.grad is not None
                               else torch.zeros_like(p))
                              for n, p in model.named_parameters()])


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def adamw_runs(request):
    return request.param, _run_both(request.param, "adamw")


def test_adamw_steps_match_jax(adamw_runs):
    arch, r = adamw_runs
    np.testing.assert_allclose(r["tl"], r["jl"], rtol=0, atol=LOSS_TOL)
    for name, w in r["jp"].items():
        err = np.abs(r["tp"][name] - w).max()
        assert err <= 2 * LR * STEPS, (name, err)
    for k in ("m", "v"):
        got, want = _flat(r["tfirst"][k]), _flat(_np_tree(r["jfirst"][k]))
        for name, w in want.items():
            scale = np.abs(w).max()
            err = np.abs(got[name] - w).max()
            assert err <= MOMENT_TOL * scale, (k, name, err, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_sgd_steps_match_jax(arch):
    r = _run_both(arch, "sgd")
    np.testing.assert_allclose(r["tl"], r["jl"], rtol=0, atol=LOSS_TOL)
    for name, w in r["jp"].items():
        moved = np.abs(w - r["init"][name]).max()
        err = np.abs(r["tp"][name] - w)
        bound = SGD_TOL * moved + STEPS * np.spacing(np.abs(w))
        assert (err <= bound).all(), (name, err.max(), moved)
    state = opt_state_to_numpy(r["cfg"], "sgd", r["to"])
    for name, w in _flat(_np_tree(r["jo"])).items():
        err = np.abs(_flat(state)[name] - w).max()
        assert err <= SGD_TOL * np.abs(w).max() * STEPS, (name, err)


def test_adafactor_steps_match_jax_on_deepseek():
    """Adafactor factors each stacked leaf: the state has the JAX shapes
    ((2, 256) ln1 -> vr (2,), vc (256,)) and values, and the params
    follow."""
    r = _run_both("deepseek-v3-671b", "adafactor")
    np.testing.assert_allclose(r["tl"], r["jl"], rtol=0, atol=LOSS_TOL)
    state = _flat(opt_state_to_numpy(r["cfg"], "adafactor", r["to"]))
    want = _flat(_np_tree(r["jo"]))
    assert set(state) == set(want)
    assert state["layers.ln1.vr"].shape == (2,)
    assert state["layers.ln1.vc"].shape == (256,)
    for name, w in want.items():
        assert state[name].shape == w.shape, name
        err = np.abs(state[name] - w).max()
        assert err <= FACTOR_TOL * np.abs(w).max(), (name, err)
    for name, w in r["jp"].items():
        moved = np.abs(w - r["init"][name]).max()
        err = np.abs(r["tp"][name] - w)
        bound = FACTOR_PARAM_TOL * moved + STEPS * np.spacing(np.abs(w))
        assert (err <= bound).all(), (name, err.max(), moved)


def _bf16(cfg):
    return dataclasses.replace(cfg, dtype="bfloat16")


@pytest.mark.parametrize("arch,grad_dtype", [
    ("qwen3-14b", None), ("granite-moe-3b-a800m", None),
    ("smollm-135m", "bfloat16")])
def test_bf16_train_steps_follow_jax(arch, grad_dtype):
    """bf16 parameters (bf16 activations, f32 moments and update), and f32
    parameters with bf16 gradients."""
    cfg_fn = _bf16 if grad_dtype is None else (lambda c: c)
    r = _run_both(arch, "adamw", cfg_fn, grad_dtype)
    want_dtype = torch.float32 if grad_dtype else torch.bfloat16
    assert r["model"]["embed"].dtype == want_dtype
    np.testing.assert_allclose(r["tl"], r["jl"], rtol=0, atol=BF16_TOL)
    for name, w in r["jp"].items():
        err = np.abs(r["tp"][name] - w)
        bound = 2 * LR * STEPS + bf16_ulp(np.abs(w))
        assert (err <= bound).all(), (name, err.max())


def test_train_step_refuses_a_kernel_scan_model():
    """The CUDA scans have no backward: a model whose policy routes a scan
    to its kernel is refused up front, on any device; its plain-scan twin
    trains."""
    for arch, scan in (("rwkv6-1.6b", "rwkv6_wkv"),
                       ("zamba2-2.7b", "mamba2_scan")):
        cfg = get_config(arch).reduced()
        for policy in (None, "kernel"):
            model = build_model(cfg, device="cpu", policy=policy)
            with pytest.raises(ValueError, match=f"{scan}.*no backward"):
                make_train_step(model)
        assert callable(make_train_step(
            build_model(cfg, device="cpu", policy="reference"))[1])
    # a family without scans takes any policy
    assert callable(make_train_step(build_model(
        get_config("smollm-135m").reduced(), device="cpu"))[1])


def test_default_optimizer_matches_jax():
    from repro.runtime.steps import default_optimizer as jdefault
    for arch in ARCHS:
        assert (steps.default_optimizer(get_config(arch))
                == jdefault(jax_get_config(arch)))
    assert steps.default_optimizer(get_config("deepseek-v3-671b")) \
        == "adafactor"


def test_opt_state_round_trips_through_the_converter():
    cfg = get_config("zamba2-2.7b").reduced()
    model = build_model(cfg, device="cpu", policy="reference")
    for name in ("sgd", "adamw", "adafactor"):
        init_state, train_step = make_train_step(model, name)
        opt, step = init_state()
        jb, tb = _batches(cfg, 1)
        opt, step, _ = train_step(opt, step, tb)
        tree = opt_state_to_numpy(cfg, name, opt)
        back = opt_state_from_numpy(cfg, name, tree, device="cpu")
        again = opt_state_to_numpy(cfg, name, back)
        for (pa, a), (pb, b) in zip(_flat(tree).items(),
                                    _flat(again).items()):
            assert pa == pb
            np.testing.assert_array_equal(a, b)
    assert layer_stacks(cfg) == {"mamba": (2, 1)}

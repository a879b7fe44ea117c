"""The port's LM pretraining example (``python -m
repro_torch.examples.lm_pretrain``) against the JAX package's
``examples/lm_pretrain.py`` on the CPU, and the reference's loss-decrease
tests (tests/test_runtime.py) twinned.

The example's tokens are the reference's (the same numpy Zipf draw); with
the JAX-initialised weights carried across (``convert``), its losses equal
the JAX loop's at ``LOSS_TOL`` 1e-5 (f32 losses of O(6); the f32 parity
bound of tests/test_torch_train.py).
"""
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models.transformer import build_model as jax_build_model
from repro.runtime.steps import make_train_step as jax_train_step
from repro_torch.checkpoint import io as ckpt
from repro_torch.configs.base import get_config
from repro_torch.convert import model_params_from_numpy
from repro_torch.examples import lm_pretrain
from repro_torch.models.transformer import build_model
from repro_torch.runtime.steps import make_train_step

from torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
LOSS_TOL = 1e-5
ARCHS = ("smollm-135m", "qwen3-14b", "granite-20b", "nemotron-4-15b",
         "internvl2-1b", "granite-moe-3b-a800m", "deepseek-v3-671b",
         "seamless-m4t-medium", "rwkv6-1.6b", "zamba2-2.7b")


def _reference_example():
    spec = importlib.util.spec_from_file_location(
        "reference_lm_pretrain", ROOT / "examples" / "lm_pretrain.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_token_stream_is_the_reference_one():
    ref = _reference_example().token_stream(512, 2, 64)
    got = lm_pretrain.token_stream(512, 2, 64)
    for _ in range(4):
        np.testing.assert_array_equal(next(got), next(ref))


def test_reduced_run_matches_the_jax_example(monkeypatch, capsys):
    """Three steps of ``--reduced`` from the JAX example's weights
    (``init_state(PRNGKey(0))``) and tokens: the losses, and the printed
    lines but for the seconds a step."""
    argv = ["--reduced", "--steps", "3"]
    jcfg = jax_get_config("smollm-135m").reduced()
    jm = jax_build_model(jcfg, remat=False)
    init_state, train_step = jax_train_step(jm, optimizer="adamw", lr=3e-4)
    params, opt, step = init_state(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jax.device_get(params))
    stream = _reference_example().token_stream(jcfg.vocab_size, 2, 64)
    jstep = jax.jit(train_step)
    want = []
    for _ in range(3):
        params, opt, step, m = jstep(params, opt, step,
                                     {"tokens": jnp.asarray(next(stream))})
        want.append(float(m["loss"]))

    def with_jax_weights(cfg, **kw):
        model = build_model(cfg, **kw)
        model.load_state_dict(model_params_from_numpy(cfg, tree,
                                                      device=kw["device"]))
        return model

    monkeypatch.setattr(lm_pretrain, "build_model", with_jax_weights)
    got = lm_pretrain.main(argv + ["--device", "cpu"])
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_TOL)
    port_out = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["lm_pretrain.py"] + argv)
    _reference_example().main()
    ref_out = capsys.readouterr().out.splitlines()
    assert port_out[0] == ref_out[0]            # arch, params, optimizer
    assert len(port_out) == len(ref_out) == 4
    for a, b in zip(port_out[1:], ref_out[1:]):
        assert a.split("(")[0] == b.split("(")[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_every_reduced_arch_trains_through_the_example(arch, capsys):
    losses = lm_pretrain.main(["--arch", arch, "--reduced", "--steps", "2",
                               "--seq", "16", "--device", "cpu"])
    assert len(losses) == 2 and np.isfinite(losses).all()
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"arch={arch} ") and "optimizer=adamw" in out[0]


def test_ckpt_round_trips(tmp_path, monkeypatch):
    built = []

    def keep(cfg, **kw):
        built.append(build_model(cfg, **kw))
        return built[-1]

    monkeypatch.setattr(lm_pretrain, "build_model", keep)
    path = tmp_path / "lm"
    lm_pretrain.main(["--arch", "zamba2-2.7b", "--reduced", "--steps", "2",
                      "--seq", "16", "--device", "cpu", "--ckpt",
                      str(path)])
    trained = built[0]
    fresh = build_model(trained.cfg, device="cpu", policy="reference")
    ckpt.restore(path, fresh.tree())
    for (n, a), (m, b) in zip(trained.named_parameters(),
                              fresh.named_parameters()):
        assert n == m and torch.equal(a, b), n
    assert ckpt.manifest(path)["metadata"] == {"arch": "zamba2-2.7b",
                                               "steps": 2}


def _memorise(arch, steps):
    cfg = get_config(arch).reduced()
    model = build_model(cfg, remat=False, device="cpu")
    init_state, train_step = make_train_step(model, optimizer="adamw",
                                             lr=3e-3)
    opt, step = init_state()
    tok = torch.randint(0, cfg.vocab_size, (4, 32),
                        generator=torch.Generator().manual_seed(1))
    losses = []
    for _ in range(steps):
        opt, step, m = train_step(opt, step, {"tokens": tok})
        losses.append(m["loss"].item())
    return losses


def test_train_loss_decreases_smollm():
    losses = _memorise("smollm-135m", 30)
    assert losses[-1] < 0.5 * losses[0], losses[::10]


def test_moe_train_step_balances_and_learns():
    losses = _memorise("granite-moe-3b-a800m", 25)
    assert losses[-1] < losses[0]

"""The port's CUDA kernels and trainer on the card.

These tests need an NVIDIA card with the CUDA toolkit (the kernels are built
from ``src/repro_torch/kernels/csrc`` at first use) and skip elsewhere.  This
file imports no jax, so it runs on a machine that has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import collections

import numpy as np
import pytest
import torch

from repro_torch.configs.splitme_dnn import DNN10, DNNConfig
from repro_torch.core import dnn, engine, quantcomm
from repro_torch.core.cost import SystemParams
from repro_torch.core.splitme import SplitMeTrainer
from repro_torch.data import oran
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention as fa_ref
from repro_torch.kernels.kl_mutual import ops as kl_ops
from repro_torch.kernels.kl_mutual.ref import kl_grad_ref, kl_rows_ref
from repro_torch.kernels.mamba2_scan import ops as ssd_ops
from repro_torch.kernels.mamba2_scan.ref import mamba2_scan_ref
from repro_torch.kernels.ridge_gram import ops as rg_ops
from repro_torch.kernels.ridge_gram.ref import gram_ref
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.kernels.rwkv6_wkv.ref import rwkv6_wkv_ref
from repro_torch.configs.base import get_config
from repro_torch.launch import campaign
from repro_torch.models.transformer import build_model
from repro_torch.runtime.steps import make_prefill_step

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _normal(seed, shape, device, scale=1.0):
    g = np.random.default_rng(seed)
    return torch.tensor(g.normal(size=shape) * scale, dtype=torch.float32,
                        device=device)


# (rows, d) of the KL kernels: the main path's (50 clients x 32 rows of
# 256), a ragged width, single floats (d % 4 != 0), 32 values a lane (d
# 1000), a row streamed (d > 1024), the campaign's cohorts of 32 and 50
# clients x 4 seeds x 32 rows, and the config sweep's 16 pairs x 50 slots x
# 32 rows
_KL_SHAPES = [(1600, 256), (1000, 200), (7, 3), (33, 1000), (5, 5000),
              (4096, 256), (6400, 256), (25600, 256)]


def _off_alignment(t, offset):
    """t copied ``offset`` floats past an aligned address (t at 0)."""
    if not offset:
        return t
    buf = torch.empty(offset + t.numel(), device=t.device)
    return buf[offset:].view(t.shape).copy_(t)


@pytest.mark.parametrize("rows,d", _KL_SHAPES)
@pytest.mark.parametrize("temp", [1.0, 2.0])
def test_kl_kernel_matches_plain(cuda, rows, d, temp):
    x, y = _normal(0, (rows, d), cuda, 3.0), _normal(1, (rows, d), cuda, 3.0)
    before = kl_ops.launches
    got = kl_ops.kl_rows(x, y, temp)
    assert kl_ops.launches == before + 1
    torch.testing.assert_close(got, kl_rows_ref(x, y, temp), rtol=1e-6,
                               atol=1e-5)


# g at stride 1 (a value per row), or at stride 0 (one value for every
# row, as a mean over the rows hands it over); x off 16-byte alignment takes
# the kernels' single-float loads at d % 4 == 0
@pytest.mark.parametrize("rows,d", _KL_SHAPES)
@pytest.mark.parametrize("g_stride", [1, 0])
@pytest.mark.parametrize("x_offset", [0, 1])
def test_kl_grad_kernel_matches_plain(cuda, rows, d, g_stride, x_offset):
    x = _off_alignment(_normal(2, (rows, d), cuda, 3.0), x_offset)
    y = _normal(3, (rows, d), cuda, 3.0)
    g = (_normal(4, (rows,), cuda) if g_stride
         else torch.full((1,), 0.37, device=cuda).expand(rows))
    before = kl_ops.launches, kl_ops.launches_bwd
    got = kl_ops.kl_grad(x, y, g, 2.0)
    assert (kl_ops.launches, kl_ops.launches_bwd) == (before[0],
                                                      before[1] + 1)
    want = kl_grad_ref(x, y, g, 2.0)
    # KL_TOL x max|grad|, the bound chip_smoke.py holds it to
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    before = kl_ops.launches
    torch.testing.assert_close(kl_ops.kl_rows(x, y, 2.0),
                               kl_rows_ref(x, y, 2.0), rtol=1e-6, atol=1e-5)
    assert kl_ops.launches == before + 1


def test_kl_kernel_gradient_matches_plain(cuda):
    x, y = _normal(2, (50, 32, 256), cuda), _normal(3, (50, 32, 256), cuda)
    grads = {}
    for pol in ("kernel", "reference"):
        tx = x.clone().requires_grad_(True)
        before = kl_ops.launches_bwd
        loss = dispatch.kl_loss(tx, y, temperature=2.0, policy=pol)
        loss.sum().backward()
        # the kernel preset's backward is one launch of the gradient kernel
        assert kl_ops.launches_bwd == before + (pol == "kernel")
        grads[pol] = (loss.detach(), tx.grad)
    torch.testing.assert_close(grads["kernel"][0], grads["reference"][0],
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(grads["kernel"][1], grads["reference"][1],
                               rtol=0, atol=1e-7)


# the mixed-dtype KL entries: every (x, y) pair with a bf16 operand, at
# the shapes above and at a width with d % 8 != 0 (single-element loads),
# with x aligned or one element off (single-element loads at d % 8 == 0)
_KL_PAIRS = [(torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16),
             (torch.bfloat16, torch.bfloat16)]


def _bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 unit in the last place at |v| (8 significant bits)."""
    mag = v.double().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


# the f32 shapes but the config sweep's (no bf16 path gives it) and a
# width with d % 8 != 0
@pytest.mark.parametrize("rows,d", _KL_SHAPES[:-1] + [(100, 37)])
@pytest.mark.parametrize("tx,ty", _KL_PAIRS)
@pytest.mark.parametrize("x_offset", [0, 1])
def test_kl_mixed_kernels_match_plain(cuda, rows, d, tx, ty, x_offset):
    """Forward within the f32 rows' bounds, the gradient in x's dtype: a
    bf16 gx within one bf16 ulp (plus the f32 rounding of the closed form,
    2^-23 of its largest element) of the plain version's, which rounds the
    same f32 value.  Each call launches its pair's entry, never the f32
    one."""
    x = _normal(10, (rows, d), cuda, 3.0).to(tx)
    if x_offset:
        buf = torch.empty(x_offset + x.numel(), dtype=tx, device=cuda)
        x = buf[x_offset:].view(x.shape).copy_(x)
    y = _normal(11, (rows, d), cuda, 3.0).to(ty)
    g = torch.full((1,), 0.37, device=cuda).expand(rows)
    kl_ops.launches_by_entry.clear()
    got = kl_ops.kl_rows(x, y, 2.0)
    gx = kl_ops.kl_grad(x, y, g, 2.0)
    names = {kl_ops.entry("rows", x, y), kl_ops.entry("grad", x, y)}
    assert kl_ops.launches_by_entry == {n: 1 for n in names}
    assert not names & {"kl_mutual_rows_f32", "kl_mutual_grad_f32"}
    torch.testing.assert_close(got, kl_rows_ref(x, y, 2.0), rtol=1e-6,
                               atol=1e-5)
    want = kl_grad_ref(x, y, g, 2.0)
    assert gx.dtype == want.dtype == tx
    err = (gx.double() - want.double()).abs()
    slack = 2.0 ** -23 * want.double().abs().max()
    if tx == torch.bfloat16:
        ulp = _bf16_ulp(torch.maximum(gx.double().abs(),
                                      want.double().abs()))
        assert bool((err <= ulp + slack).all()), float(err.max())
    else:
        assert err.max().item() <= 1e-5 * want.abs().max().item()


def test_kl_mixed_gradient_through_the_phase_losses(cuda):
    """dispatch.kl_loss with bf16 smashed data against an f32 target (the
    client phase) and f32 against a bf16 target (the server phase): the
    kernel policy's gradients within one bf16 ulp of the reference
    policy's, in x's dtype, one backward launch each."""
    for tx, ty in _KL_PAIRS[:2]:
        x = _normal(12, (50, 32, 256), cuda).to(tx)
        y = _normal(13, (50, 32, 256), cuda).to(ty)
        grads = {}
        for pol in ("kernel", "reference"):
            t = x.clone().requires_grad_(True)
            before = kl_ops.launches_bwd
            dispatch.kl_loss(t, y, temperature=2.0,
                             policy=pol).sum().backward()
            assert kl_ops.launches_bwd == before + (pol == "kernel")
            assert t.grad.dtype == tx
            grads[pol] = t.grad.double()
        err = (grads["kernel"] - grads["reference"]).abs()
        ulp = _bf16_ulp(torch.maximum(grads["kernel"].abs(),
                                      grads["reference"].abs()))
        slack = 2.0 ** -23 * grads["reference"].abs().max()
        assert bool((err <= ulp + slack).all()), float(err.max())


def test_mixed_matmul_has_an_f32_output_on_the_card(cuda):
    """The mixed forward's bf16 x bf16 products keep their f32 sums (one
    GEMM with an f32 output): within f32 summation error of the widened
    product, far inside a bf16 rounding of the output."""
    a = _normal(14, (3, 64, 256), cuda).bfloat16()
    b = _normal(15, (3, 256, 128), cuda).bfloat16()
    for bb in (b, b[0]):                   # client-stacked, global weights
        got = dnn._matmul_f32(a, bb)
        want = a.double() @ bb.double()
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert (got.double() - want).abs().max().item() <= \
            1e-5 * want.abs().max().item()


@pytest.mark.parametrize("n,d1,d2", [(4800, 257, 257), (4800, 257, 128),
                                     (4800, 17, 3), (777, 45, 19),
                                     (1, 1, 1), (70, 33, 65),
                                     (300, 64, 128)])
def test_gram_kernel_matches_plain(cuda, n, d1, d2):
    x, y = _normal(4, (n, d1), cuda), _normal(5, (n, d2), cuda)
    before = rg_ops.launches
    got = rg_ops.gram(x, y)
    assert rg_ops.launches == before + 1
    scale = (x.abs().T @ y.abs()).max().item()
    torch.testing.assert_close(got, gram_ref(x, y), rtol=0,
                               atol=1e-5 * scale)
    # deterministic: fixed-order split reduction, no atomics
    assert torch.equal(got, rg_ops.gram(x, y))


# (n, d1, d2) of gram_pair: the 8 server layers of DNN10 at n = 4800 (d1 the
# bias-augmented input width), ragged n and widths, and widths that are all
# multiples of 4
@pytest.mark.parametrize("n,d1,d2", [
    (4800, 257, 128), (4800, 129, 128), (4800, 129, 64), (4800, 65, 64),
    (4800, 65, 32), (4800, 33, 32), (4800, 33, 16), (4800, 17, 3),
    (1, 1, 1), (777, 17, 257), (777, 257, 1), (1, 257, 17), (777, 1, 17),
    (512, 64, 32)])
def test_gram_pair_kernel_matches_plain(cuda, n, d1, d2):
    o, z = _normal(6, (n, d1), cuda), _normal(7, (n, d2), cuda)
    before = rg_ops.launches
    got = rg_ops.gram_pair(o, z)
    assert rg_ops.launches == before + 1
    for g, y in zip(got, (o, z)):
        scale = (o.abs().T @ y.abs()).max().item()
        torch.testing.assert_close(g, gram_ref(o, y), rtol=0,
                                   atol=1e-5 * scale)
    again = rg_ops.gram_pair(o, z)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_wrappers_refuse_mixed_devices(cuda):
    with pytest.raises(ValueError):
        kl_ops.kl_rows(torch.zeros(4, 4, device=cuda), torch.zeros(4, 4), 1.0)
    with pytest.raises(ValueError):
        rg_ops.gram(torch.zeros(4, 4, device=cuda), torch.zeros(4, 2))
    with pytest.raises(ValueError):
        rg_ops.gram_pair(torch.zeros(4, 4, device=cuda), torch.zeros(4, 2))


def test_trainer_on_card_matches_cpu(cuda):
    X, y = oran.generate(n_per_class=200, seed=0)
    train, test = oran.train_test_split(X, y)
    clients = oran.partition_non_iid(*train, 10, 32, seed=0)
    cfg = DNNConfig(hidden=(64, 64, 32, 32, 16))
    runs = {}
    for dev in ("cuda", "cpu"):
        kl_ops.launches = kl_ops.launches_bwd = rg_ops.launches = 0
        t = SplitMeTrainer(cfg, SystemParams(M=10, E_max=4), clients, test,
                           batch_size=8, e_initial=4, seed=0, device=dev)
        hist = [t.run_round(eval_acc=r == 1) for r in range(2)]
        t.fetch_history()
        runs[dev] = (t, hist, kl_ops.launches, kl_ops.launches_bwd,
                     rg_ops.launches)
    tc, hc, kl_n, kl_bwd_n, rg_n = runs["cuda"]
    tp, hp, _, _, _ = runs["cpu"]
    # one Gram-pair launch per server layer (4) at the one evaluation, one
    # KL gradient launch per executed training step of the two phases
    assert kl_n == 2 * 2 * 4 and rg_n == 4
    assert kl_bwd_n == sum(2 * m.E for m in hc)
    for p, q in zip(tc.w_c + tc.w_s_inv, tp.w_c + tp.w_s_inv):
        for k in ("w", "b"):
            torch.testing.assert_close(p[k].cpu(), q[k], rtol=0, atol=1e-5)
    for a, b in zip(hc, hp):
        assert abs(a.client_loss - b.client_loss) <= 1e-5
        assert abs(a.server_loss - b.server_loss) <= 1e-5


# tolerance of the WKV and SSD kernels against their plain versions,
# relative to max|y|: both are f32 recurrences summed in another order
SCAN_TOL = 1e-5


def _exact_0and1(seed, d):
    """d with about 5 % of its entries set to exactly 0 and 10 % to exactly
    1."""
    pick = torch.tensor(np.random.default_rng(seed).random(size=d.shape),
                        device=d.device)
    return d.masked_fill(pick < 0.05, 0.0).masked_fill(pick > 0.9, 1.0)


# the decay: None or False for the random one, a number for a constant one,
# True for the constant 1e-4, "0and1" for exact 0s and 1s among the random
# ones.  Cases: the main path's shape, small and odd shapes, a strong
# constant decay, and (as in chip_smoke.py's WKV_CASES / SSD_CASES) a ragged
# length at full width, a long memory (0.999) and exact 0 / 1 decays
@pytest.mark.parametrize("b,L,nh,P,w_scale", [
    (4, 2048, 32, 64, None), (1, 1, 32, 64, None), (2, 100, 5, 64, None),
    (2, 50, 3, 16, None), (1, 70, 2, 128, None), (1, 33, 2, 32, None),
    (1, 128, 2, 64, 1e-4), (4, 2048 + 17, 32, 64, None),
    (1, 2048, 32, 64, 0.999), (1, 300, 8, 64, "0and1")])
def test_wkv_kernel_matches_plain(cuda, b, L, nh, P, w_scale):
    r, k, v = (_normal(10 + i, (b, L, nh, P), cuda) for i in range(3))
    if isinstance(w_scale, float):
        w = torch.full((b, L, nh, P), w_scale, device=cuda)
    else:
        w = torch.sigmoid(_normal(13, (b, L, nh, P), cuda))
        if w_scale == "0and1":
            w = _exact_0and1(15, w)
    u = _normal(14, (nh, P), cuda)
    before = wkv_ops.launches
    got = wkv_ops.rwkv6_wkv(r, k, v, w, u)
    assert wkv_ops.launches == before + 1
    want = rwkv6_wkv_ref(r, k, v, w, u)
    err = (got - want).abs().max().item()
    assert err <= SCAN_TOL * want.abs().max().item(), err


@pytest.mark.parametrize("b,L,nh,N,P,decay", [
    (4, 2048, 80, 64, 64, False), (1, 1, 80, 64, 64, False),
    (2, 100, 5, 64, 64, False), (1, 128, 2, 8, 16, True),
    (2, 37, 3, 16, 32, False), (1, 40, 2, 128, 96, False),
    (4, 2048 + 17, 80, 64, 64, False), (1, 2048, 80, 64, 64, 0.999),
    (1, 300, 8, 64, 64, "0and1")])
def test_ssd_kernel_matches_plain(cuda, b, L, nh, N, P, decay):
    if decay is True:
        decay = torch.full((b, L, nh), 1e-4, device=cuda)
    elif isinstance(decay, float):
        decay = torch.full((b, L, nh), decay, device=cuda)
    else:
        spec = decay
        decay = torch.sigmoid(_normal(20, (b, L, nh), cuda)) * 0.6 + 0.35
        if spec == "0and1":
            decay = _exact_0and1(25, decay)
    dt = torch.nn.functional.softplus(_normal(21, (b, L, nh), cuda))
    B, C = _normal(22, (b, L, N), cuda), _normal(23, (b, L, N), cuda)
    x = _normal(24, (b, L, nh, P), cuda)
    before = ssd_ops.launches
    got = ssd_ops.mamba2_scan(decay, dt, B, C, x)
    assert ssd_ops.launches == before + 1
    want = mamba2_scan_ref(decay, dt, B, C, x)
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= SCAN_TOL * want.abs().max().item(), err


def test_scan_wrappers_refuse_mixed_devices(cuda):
    z = torch.zeros(1, 2, 1, 4, device=cuda)
    with pytest.raises(ValueError):
        wkv_ops.rwkv6_wkv(z, z, z, z, torch.zeros(1, 4))
    d = torch.zeros(1, 2, 1, device=cuda)
    with pytest.raises(ValueError):
        ssd_ops.mamba2_scan(d, d, torch.zeros(1, 2, 3), d.new_zeros(1, 2, 3),
                            z)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-2.7b"])
def test_reduced_model_on_card_matches_cpu(cuda, arch):
    """The reduced model in f32: forward logits (through the kernels on the
    card, the plain scans on the CPU) and 8 decode steps agree, and the
    prefill launches one scan kernel per layer."""
    cfg = get_config(arch).reduced()
    mc = build_model(cfg, device=cuda)
    mp = build_model(cfg, device="cpu")
    mp.load_state_dict({k: v.cpu() for k, v in mc.state_dict().items()})
    tok = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)))
    counter = wkv_ops if cfg.family == "ssm" else ssd_ops
    before = counter.launches
    with torch.no_grad():
        lc = make_prefill_step(mc)({"tokens": tok.to(cuda)})
        lp = make_prefill_step(mp)({"tokens": tok})
        assert counter.launches == before + cfg.n_layers
        tol = 1e-5 * lp.abs().max().item()
        assert (lc.cpu() - lp).abs().max().item() <= tol
        cc, cp = mc.init_cache(2), mp.init_cache(2)
        for t in range(8):
            a, cc = mc.decode_step(tok[:, t:t + 1].to(cuda), cc)
            b, cp = mp.decode_step(tok[:, t:t + 1], cp)
            assert (a.cpu() - b).abs().max().item() <= tol


_DECODER_ARCHS = ["smollm-135m", "qwen3-14b", "granite-20b", "nemotron-4-15b",
                  "internvl2-1b", "granite-moe-3b-a800m", "deepseek-v3-671b",
                  "seamless-m4t-medium"]


@pytest.mark.parametrize("arch", _DECODER_ARCHS)
def test_reduced_decoder_on_card_matches_cpu(cuda, arch):
    """The decoder and enc-dec families, reduced, in f32: forward logits
    (with the frontend's embeddings, and MTP logits), and 8 decode steps
    (an enc-dec's from its encoder's memory) agree with the CPU within
    1e-5 of max|logits|; no kernel launches on these paths."""
    cfg = get_config(arch).reduced()
    mc = build_model(cfg, device=cuda)
    mp = build_model(cfg, device="cpu")
    mp.load_state_dict({k: v.cpu() for k, v in mc.state_dict().items()})
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.tensor(rng.integers(0, cfg.vocab_size,
                                                 (2, 16)))}
    if cfg.frontend:
        batch["embeds"] = torch.tensor(rng.normal(
            size=(2, cfg.frontend_positions, cfg.d_model)),
            dtype=torch.float32)
    on_card = {k: v.to(cuda) for k, v in batch.items()}
    counters = (fa_ops.launches, wkv_ops.launches, ssd_ops.launches)
    with torch.no_grad():
        lc, xc = mc.forward(on_card)
        lp, xp = mp.forward(batch)
        tol = 1e-5 * lp.abs().max().item()
        assert (lc.cpu() - lp).abs().max().item() <= tol
        assert set(xc) == set(xp)
        if cfg.mtp:
            assert (xc["mtp_logits"].cpu() - xp["mtp_logits"]).abs().max() \
                .item() <= tol
        if cfg.is_enc_dec:
            cc = mc.init_cache(2, memory=mc.encode(on_card["embeds"]))
            cp = mp.init_cache(2, memory=mp.encode(batch["embeds"]))
        else:
            cc, cp = mc.init_cache(2), mp.init_cache(2)
        tok = batch["tokens"]
        for t in range(8):
            a, cc = mc.decode_step(tok[:, t:t + 1].to(cuda), cc)
            b, cp = mp.decode_step(tok[:, t:t + 1], cp)
            assert (a.cpu() - b).abs().max().item() <= tol
    assert counters == (fa_ops.launches, wkv_ops.launches, ssd_ops.launches)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "deepseek-v3-671b"])
def test_moe_on_card_is_deterministic(cuda, arch):
    """The MoE layer sums each token's experts in a fixed order (no
    atomics): two bf16 forward passes on the card agree bit for bit."""
    import dataclasses
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    model = build_model(cfg, device=cuda)
    tok = torch.tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (4, 64)), device=cuda)
    with torch.no_grad():
        a, xa = model.forward({"tokens": tok})
        b, xb = model.forward({"tokens": tok})
    assert torch.equal(a, b) and torch.equal(xa["aux"], xb["aux"])


# the flash-attention kernel against its plain version, (rtol, atol) per
# element: in f32 the JAX package's own bound (tests/test_kernels.py), sums
# in another order; in bf16 one bf16 unit in the last place of the plain
# output (2^-7 of its magnitude), since both sides round an f32 result to
# nearest, so the bound follows the output's scale
FA_TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (2 ** -7, 1e-5)}


# the same cases as chip_smoke.py's FLASH_CASES with qk_shift 0: keep the lists
# equal
@pytest.mark.parametrize("B,H,KV,S,D,window,scale,v_shift", [
    (2, 4, 2, 128, 64, None, None, 0.0), (2, 4, 2, 128, 64, 64, None, 0.0),
    (1, 8, 1, 256, 64, None, None, 0.0), (1, 8, 1, 256, 64, 64, None, 0.0),
    (2, 3, 3, 96, 32, None, None, 0.0), (2, 3, 3, 96, 32, 64, None, 0.0),
    (1, 2, 2, 64, 128, None, None, 0.0), (1, 2, 2, 64, 128, 64, None, 0.0),
    (1, 4, 2, 1, 64, None, None, 0.0), (1, 4, 2, 17, 80, None, None, 0.0),
    (2, 4, 2, 100, 80, 64, None, 0.0), (1, 4, 2, 1000, 128, None, None, 0.0),
    (1, 40, 8, 300, 128, None, None, 0.0),
    (1, 40, 8, 300, 128, 100, None, 0.0),
    (1, 32, 32, 200, 80, None, None, 0.0),
    (1, 4, 2, 2048, 64, 512, None, 0.0), (1, 4, 2, 100, 64, 1, None, 0.0),
    (1, 4, 2, 128, 64, None, 0.3, 0.0), (1, 4, 2, 100, 40, None, None, 0.0),
    (1, 4, 2, 100, 20, None, None, 0.0),
    (1, 40, 8, 1000, 128, 100, None, 0.0), (1, 4, 2, 65, 64, None, None, 0.0),
    (1, 4, 2, 100, 16, 64, None, 0.0), (1, 4, 2, 100, 96, 64, None, 0.0),
    (1, 4, 2, 65, 112, None, None, 0.0),
    (4, 32, 32, 2048, 80, None, None, 2.0),
    (1, 5, 1, 16384, 128, 8192, None, 2.0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, B, H, KV, S, D, window, scale,
                                    v_shift, dtype):
    q = _normal(30, (B, H, S, D), cuda).to(dtype)
    k = _normal(31, (B, KV, S, D), cuda).to(dtype)
    # v_shift 2: V of one sign, so that the terms of P V all have one sign
    v = (_normal(32, (B, KV, S, D), cuda) + v_shift).to(dtype)
    # the op's own rule picks the kernel (the output is a fresh allocation,
    # aligned as q is); the routes are tested in tests/test_torch_flash.py
    route, width = fa_ops._route(dtype, D, (q.data_ptr(), k.data_ptr(),
                                            v.data_ptr(), q.data_ptr()))
    # every case takes a tensor-core kernel, f32 the 3xTF32 one and bf16 the
    # bf16 one; fresh tensors are aligned, so the copies are as wide as a
    # row of D elements allows
    assert route == ("tf32x3" if dtype == torch.float32 else "mma")
    assert width == _widest_copy(dtype, D, 0, 0)
    counter = f"launches_{route}"
    before = fa_ops.launches, getattr(fa_ops, counter)
    got = fa_ops.flash_attention(q, k, v, scale=scale, window=window)
    assert (fa_ops.launches, getattr(fa_ops, counter)) == (before[0] + 1,
                                                           before[1] + 1)
    assert got.dtype == dtype and got.shape == q.shape
    want = fa_ref(q, k, v, scale=scale or D ** -0.5, window=window)
    rtol, atol = FA_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


# q and k of one sign (each a normal plus 2), so that the terms of S = Q Kᵀ
# all have one sign, at Zamba2-2.7B's shape and at Qwen3-14B's window of
# 8192 on one KV head; the same cases as chip_smoke.py's FLASH_CASES with
# qk_shift 2
@pytest.mark.parametrize("B,H,KV,S,D,window", [
    (4, 32, 32, 2048, 80, None), (1, 5, 1, 16384, 128, 8192)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_one_sign_qk_matches_plain(cuda, B, H, KV, S, D, window,
                                                dtype):
    q = (_normal(40, (B, H, S, D), cuda) + 2.0).to(dtype)
    k = (_normal(41, (B, KV, S, D), cuda) + 2.0).to(dtype)
    v = _normal(42, (B, KV, S, D), cuda).to(dtype)
    route = "tf32x3" if dtype == torch.float32 else "mma"
    before = getattr(fa_ops, f"launches_{route}")
    got = fa_ops.flash_attention(q, k, v, window=window)
    assert getattr(fa_ops, f"launches_{route}") == before + 1
    want = fa_ref(q, k, v, scale=D ** -0.5, window=window)
    rtol, atol = FA_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


def test_flash_kernel_never_reaches_the_plain_version_or_sdpa(cuda,
                                                              monkeypatch):
    def trip(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a non-kernel path")
    monkeypatch.setattr(fa_ops, "attention", trip)
    monkeypatch.setattr(torch.nn.functional, "scaled_dot_product_attention",
                        trip)
    q = _normal(33, (1, 4, 100, 64), cuda)
    kv = _normal(34, (1, 2, 100, 64), cuda)
    before = fa_ops.launches
    assert torch.isfinite(fa_ops.flash_attention(q, kv, kv)).all()
    assert fa_ops.launches == before + 1


def _widest_copy(dtype, D, q_off, kv_off):
    """The copy width, in bytes, for q ``q_off`` and k, v ``kv_off``
    elements past aligned addresses (and a fresh output): 16 where both
    offsets and a row of D elements are multiples of 16 bytes, else 4
    where the K/V offset and the row are multiples of 4 bytes, else 2."""
    item = 2 if dtype == torch.bfloat16 else 4
    if q_off * item % 16 == 0 and kv_off * item % 16 == 0 \
            and D * item % 16 == 0:
        return 16
    return 4 if kv_off * item % 4 == 0 and D * item % 4 == 0 else 2


def _placed(t, offset):
    """t copied ``offset`` elements past an aligned address (t at 0)."""
    if not offset:
        return t
    buf = torch.empty(offset + t.numel(), dtype=t.dtype, device=t.device)
    return buf[offset:].view(t.shape).copy_(t)


def _flash_takes_the_tensor_cores(cuda, dtype, shape, window, q_off, kv_off,
                                  seed):
    """q ``q_off`` and k, v ``kv_off`` elements past aligned addresses: the
    op launches its dtype's tensor-core kernel once, with copies as wide as
    the offsets allow, and matches the plain version."""
    B, H, KV, S, D = shape
    q = _placed(_normal(seed, (B, H, S, D), cuda).to(dtype), q_off)
    k = _placed(_normal(seed + 1, (B, KV, S, D), cuda).to(dtype), kv_off)
    v = _placed(_normal(seed + 2, (B, KV, S, D), cuda).to(dtype), kv_off)
    route = "tf32x3" if dtype == torch.float32 else "mma"
    assert fa_ops._route(dtype, D, (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                    q.data_ptr())) == (
        route, _widest_copy(dtype, D, q_off, kv_off))
    before = fa_ops.launches, getattr(fa_ops, f"launches_{route}")
    got = fa_ops.flash_attention(q, k, v, window=window)
    assert (fa_ops.launches, getattr(fa_ops, f"launches_{route}")) == (
        before[0] + 1, before[1] + 1)
    assert got.dtype == dtype and got.shape == q.shape
    rtol, atol = FA_TOL[dtype]
    torch.testing.assert_close(
        got.float(), fa_ref(q, k, v, scale=D ** -0.5, window=window).float(),
        rtol=rtol, atol=atol)


def test_flash_unaligned_bf16_takes_the_mma_kernel(cuda):
    # q 2 bytes past an aligned address
    _flash_takes_the_tensor_cores(cuda, torch.bfloat16, (1, 4, 2, 100, 64),
                                  None, 1, 0, 35)


@pytest.mark.parametrize("case", ["d20", "q_unaligned"])
def test_flash_f32_off_the_old_tensor_core_rule_takes_the_tf32x3_kernel(
        cuda, case):
    # D 20 (not a multiple of 8), or q 4 bytes past an aligned address
    D, q_off = (20, 0) if case == "d20" else (64, 1)
    _flash_takes_the_tensor_cores(cuda, torch.float32, (1, 4, 2, 100, D),
                                  None, q_off, 0, 37)


# odd head sizes and inputs off alignment: ((B, H, KV, S, D), window, q
# offset, k and v offset) in elements; the same cases as chip_smoke.py's
# FLASH_ODD: keep the lists equal
@pytest.mark.parametrize("shape,window,q_off,kv_off", [
    ((1, 4, 2, 100, 1), None, 0, 0), ((1, 4, 2, 100, 20), 64, 0, 0),
    ((1, 4, 2, 100, 127), None, 0, 0), ((1, 4, 2, 100, 64), None, 1, 0),
    ((1, 4, 2, 100, 64), None, 0, 1), ((1, 4, 2, 100, 80), 64, 1, 1),
    ((1, 4, 2, 100, 127), None, 1, 1), ((2, 8, 2, 300, 80), None, 0, 2),
    ((1, 4, 2, 1000, 127), None, 0, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_odd_d_and_unaligned_inputs_take_the_tensor_cores(
        cuda, shape, window, q_off, kv_off, dtype):
    _flash_takes_the_tensor_cores(cuda, dtype, shape, window, q_off, kv_off,
                                  50)


def test_flash_wrapper_refuses_mixed_devices(cuda):
    q = torch.zeros(1, 2, 4, 8, device=cuda)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, torch.zeros(1, 2, 4, 8), q)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(torch.zeros(1, 2, 4, 8), q, q)


# ---------------------------------------------------------------------------
# the graphed SplitMe campaign (tests/test_campaign.py's fixture)
# ---------------------------------------------------------------------------

def _campaign_data():
    X, y = oran.generate(n_per_class=300, seed=0)
    (Xtr, ytr), test = oran.train_test_split(X, y)
    cd = oran.partition_non_iid(Xtr, ytr, 12, samples_per_client=32, seed=0)
    return cd, test


def _campaign(cd, **kw):
    return campaign.run_campaign("splitme", DNN10, SystemParams(M=12, seed=0),
                                 cd, rounds=3, seeds=(0, 1), **kw)


def test_graphed_campaign_equals_eager_campaign(cuda):
    """One graph per round shape and one for the evaluation; the replays
    compute the eager rounds' params and losses bit for bit, and the CPU's
    params and losses at 1e-5 and per-round accuracy within one test
    sample."""
    cd, test = _campaign_data()
    g = _campaign(cd, device=cuda, test_data=test, eval_every=2,
                  eval_gamma=10.0)
    e = _campaign(cd, device=cuda, scan=False)
    assert g.graphs["graphs"] == len(g.graphs["shapes"]) + 1
    assert sum(len(r) for r in g.graphs["shapes"].values()) == 3
    np.testing.assert_array_equal(g.losses, e.losses)
    for i in range(2):
        for hg, he in zip(g.params_for(i), e.params_for(i)):
            for pg, pe in zip(hg, he):
                for k in pg:
                    assert torch.equal(pg[k], pe[k])
    acc = g.accuracy_per_round
    assert np.isnan(acc[0]).all() and np.isfinite(acc[1:]).all()
    cpu = _campaign(cd, device="cpu", test_data=test, eval_every=2,
                    eval_gamma=10.0)
    np.testing.assert_allclose(g.losses, cpu.losses, rtol=0, atol=1e-5)
    for i in range(2):
        for hg, hc in zip(g.params_for(i), cpu.params_for(i)):
            for pg, pc in zip(hg, hc):
                for k in pg:
                    torch.testing.assert_close(pg[k].cpu(), pc[k], rtol=0,
                                               atol=1e-5)
    np.testing.assert_allclose(acc, cpu.accuracy_per_round, rtol=0,
                               atol=1.0 / len(test[1]) + 1e-9)


def test_strict_transfers_hold_on_the_card(cuda):
    """The scanned campaign's device phase runs under sync debug mode
    "error" with one host transfer; a synchronizing call in it raises, and
    the mode is restored after."""
    cd, test = _campaign_data()
    before = campaign.HOST_TRANSFERS
    res = _campaign(cd, device=cuda, test_data=test, strict_transfers=True)
    assert campaign.HOST_TRANSFERS == before + 1
    assert np.isfinite(res.losses).all()
    with pytest.raises(RuntimeError, match="synchroniz"):
        _campaign(cd, device=cuda, strict_transfers=True,
                  _round_hook=lambda r: torch.ones(1, device=cuda).item())
    assert torch.cuda.get_sync_debug_mode() == 0


def test_eval_graph_replays_give_identical_grams_and_accuracy(cuda):
    """The Step-4 evaluation captured as a graph: two replays give the
    same Grams (the Gram kernel resets its tile counters itself) and the
    eager accuracy."""
    cd, test = _campaign_data()
    spec = engine.make_spec("splitme", DNN10)
    x = torch.as_tensor(cd["x"], device=cuda)
    y = torch.as_tensor(cd["y"], dtype=torch.int64, device=cuda)
    eval_fn = engine.build_eval_fn(
        spec, DNN10, torch.as_tensor(test[0], device=cuda),
        torch.as_tensor(test[1], dtype=torch.int64, device=cuda),
        client_data={"x": x, "y": y}, gamma=10.0)
    params = spec.init_fn(torch.Generator().manual_seed(0), cuda)
    o, z = _normal(0, (384, 257), cuda), _normal(1, (384, 128), cuda)
    out = [torch.empty(257, 257, device=cuda),
           torch.empty(257, 128, device=cuda), torch.empty((), device=cuda)]

    def body():
        a0, a1 = dispatch.gram_pair(o, z)
        out[0].copy_(a0)
        out[1].copy_(a1)
        out[2].copy_(eval_fn(params))

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph, _ = campaign._capture(body, torch.cuda.graph_pool_handle(),
                                     ())
        replays = []
        for _ in range(2):
            for t in out:
                t.fill_(float("nan"))
            graph.replay()
            replays.append([t.clone() for t in out])
    torch.cuda.current_stream().wait_stream(stream)
    for a, b in zip(*replays):
        assert torch.equal(a, b)
    a0, a1 = dispatch.gram_pair(o, z)
    assert torch.equal(replays[0][0], a0) and torch.equal(replays[0][1], a1)
    assert replays[0][2].item() == eval_fn(params).item()


def test_failed_capture_raises_without_falling_back(cuda, monkeypatch):
    """A round body that waits on the card cannot be captured: the campaign
    raises, it does not run the rounds eagerly instead."""
    cd, _ = _campaign_data()
    real = engine._step_mask

    def syncing(e_max, e_steps, device):
        int(e_steps)                  # a host read: no capture allows it
        return real(e_max, e_steps, device)

    monkeypatch.setattr(engine, "_step_mask", syncing)
    with pytest.raises(RuntimeError):
        _campaign(cd, device=cuda)
    monkeypatch.undo()
    torch.cuda.synchronize()
    assert torch.ones(3, device=cuda).sum().item() == 3.0


# ---------------------------------------------------------------------------
# bf16 precision and the wire formats in the graphed campaign
# ---------------------------------------------------------------------------

def _same_campaigns(a, b):
    np.testing.assert_array_equal(a.losses, b.losses)
    for i in range(len(a.seeds)):
        for ha, hb in zip(a.params_for(i), b.params_for(i)):
            for pa, pb in zip(ha, hb):
                assert all(torch.equal(pa[k], pb[k]) for k in pa)
    qa, qb = (quantcomm.tree_leaves(r.qstate) for r in (a, b))
    assert len(qa) == len(qb) and all(torch.equal(u, v)
                                      for u, v in zip(qa, qb))


@pytest.mark.parametrize("kw", [dict(quant="int8"), dict(quant="bf16"),
                                dict(policy="kernel_bf16")],
                         ids=["int8", "bf16-wire", "kernel_bf16"])
def test_graphed_precision_campaign_equals_eager(cuda, kw):
    """The graphed campaign under int8 (EF state among the graphs' state,
    the uniforms an operand table), the bf16 wire and the bf16 policy: bit
    for bit the eager one, params, losses and EF state."""
    cd, test = _campaign_data()
    g = _campaign(cd, device=cuda, test_data=test, eval_every=2,
                  strict_transfers=True, **kw)
    e = _campaign(cd, device=cuda, scan=False, **kw)
    _same_campaigns(g, e)
    if kw.get("quant") == "int8":
        q = quantcomm.tree_leaves(g.qstate)
        assert len(q) == 20 and all(bool(torch.isfinite(v).all())
                                    and v.shape[0] == 2 for v in q)
        assert any(bool((v != 0).any()) for v in q)
    assert np.isfinite(g.accuracy_per_round[-1]).all()


def test_bf16_campaign_on_card_matches_cpu(cuda):
    """"kernel_bf16" on the card is bf16 (the mixed KL entries launch in
    the warm-ups), and matches the CPU's forced BF16 campaign at 1e-3."""
    cd, test = _campaign_data()
    kl_ops.launches_by_entry.clear()
    card = _campaign(cd, device=cuda, policy="kernel_bf16", scan=False)
    for name in ("kl_mutual_rows_bf16_f32", "kl_mutual_rows_f32_bf16",
                 "kl_mutual_grad_bf16_f32", "kl_mutual_grad_f32_bf16"):
        assert kl_ops.launches_by_entry.get(name, 0) > 0, name
    assert "kl_mutual_rows_f32" not in kl_ops.launches_by_entry
    cpu = _campaign(cd, device="cpu",
                    policy=dispatch.KernelPolicy(precision=dispatch.BF16),
                    scan=False)
    np.testing.assert_allclose(card.losses, cpu.losses, rtol=0, atol=1e-3)
    for i in range(2):
        for hg, hc in zip(card.params_for(i), cpu.params_for(i)):
            for pg, pc in zip(hg, hc):
                for k in pg:
                    torch.testing.assert_close(pg[k].cpu(), pc[k], rtol=0,
                                               atol=1e-3)


def test_fedavg_bf16_trainer_on_card_holds_the_cpu_bounds(cuda,
                                                          monkeypatch):
    """FedAvg's trainer under "kernel_bf16" on the card (bf16 there)
    against the CPU's trainer under forced bf16, the same weights and
    batches, by tests/test_torch_baseline_precision.py's rule: the first
    round within 1e-3 (params and loss); and each of three rounds under
    half the distance between the CPU's own bf16 and f32 trainers, with the
    mixed GEMM widened to the CPU's f32 product.  The tensor cores' GEMM
    sums its exact bf16 products in another way, and over three rounds the
    bf16 roundings and the SGD amplify that past the rule now and then, as
    they do a one-ulp change of the initial weights on the CPU itself
    (chip_smoke.py's bf16_rule)."""
    from repro_torch.core import baselines
    cd, test = _campaign_data()

    def trainer(device, policy):
        return baselines.FedAvgTrainer(DNN10, SystemParams(M=12, seed=0), cd,
                                       test, E=3, device=device,
                                       kernel_policy=policy)
    card, wide = trainer(cuda, "kernel_bf16"), trainer(cuda, "kernel_bf16")
    assert card._spec.policy.precision.is_mixed
    cpu = trainer("cpu", dispatch.KernelPolicy(precision=dispatch.BF16))
    f32 = trainer("cpu", None)

    def gap(a, b):
        return max(float((p[k].cpu() - q[k].cpu()).abs().max())
                   for p, q in zip(a, b) for k in p)
    for r in range(3):
        mg, mc, _ = card.run_round(), cpu.run_round(), f32.run_round()
        with monkeypatch.context() as m:
            m.setattr(dnn, "_matmul_f32", lambda a, b: a.float() @ b.float())
            wide.run_round()
        bf16_gap = gap(cpu.params, f32.params)
        if r == 0:
            assert gap(card.params, cpu.params) <= 1e-3
            assert abs(mg.client_loss - mc.client_loss) <= 1e-3
        assert gap(wide.params, cpu.params) <= 0.5 * bf16_gap, r


# ---------------------------------------------------------------------------
# the baseline frameworks and the time-varying RAN on the card
# ---------------------------------------------------------------------------

def _flipped_units(card, cpu, tol=1e-5, most=4):
    """chip_smoke.py's flipped_units: the hidden units (fewest found
    greedily, up to most + 1) whose weights hold every element of two
    params tuples more than ``tol`` apart; w_l[i, j] belongs to unit j of
    layer l (with b_l[j]) and to unit i of layer l - 1."""
    far = []
    for h, (ha, hb) in enumerate(zip(card, cpu)):
        for l, (p, q) in enumerate(zip(ha, hb)):
            for k in p:
                d = (p[k].cpu() - q[k].cpu()).abs() > tol
                for ij in d.nonzero().tolist():
                    far.append({(h, l, ij[-1])} | (
                        {(h, l - 1, ij[0])} if k == "w" and l > 0 else set()))
    n = 0
    while far and n <= most:
        unit = collections.Counter(
            u for units in far for u in units).most_common(1)[0][0]
        far = [units for units in far if unit not in units]
        n += 1
    return n + bool(far)


_BASELINES = {"fedavg": ("FedAvgTrainer", {"K": 10, "E": 3}),
              "sfl": ("SFLTrainer", {"K": 20, "E": 3}),
              "oranfed": ("ORANFedTrainer", {"E": 3}),
              "fedora": ("FedORATrainer", {"E": 3}),
              "ecofl": ("EcoFLTrainer", {"K": 10, "E": 3})}


def _framework_campaign(name, cd, rounds=3, **kw):
    return campaign.run_campaign(name, DNN10, SystemParams(M=12, seed=0),
                                 cd, rounds=rounds, seeds=(0, 1), **kw)


@pytest.mark.parametrize("name", list(_BASELINES))
def test_graphed_baseline_campaign_equals_eager_and_cpu(cuda, name):
    """Each baseline's graphed campaign (strict transfers, one graph per
    round shape and one for the evaluation) equals its eager campaign bit
    for bit; no SplitMe kernel launches.  The card against the CPU over
    two rounds: losses at 1e-5, accuracy within one test sample, params at
    1e-5 but for the weights of at most 4 hidden units a seed, within 1e-4
    (a unit whose pre-activation lies within rounding of 0 can take the
    other side of its ReLU on the card: on an H100, 28 weights of one SFL
    unit 2.3e-5 apart after 2 rounds; chip_smoke.py's FLIP_UNITS).  Over
    more rounds the
    baselines' SGD amplifies a last-bit difference, as it does a one-ulp
    change of the initial weights on one device (chip_smoke.py phase
    3d)."""
    cd, test = _campaign_data()
    kw = _BASELINES[name][1]
    kl_ops.launches = kl_ops.launches_bwd = rg_ops.launches = 0
    g = _framework_campaign(name, cd, device=cuda, test_data=test,
                            eval_every=1, strict_transfers=True, **kw)
    e = _framework_campaign(name, cd, device=cuda, scan=False, **kw)
    assert (kl_ops.launches, kl_ops.launches_bwd, rg_ops.launches) == \
        (0, 0, 0)
    assert g.graphs["graphs"] == len(g.graphs["shapes"]) + 1
    _same_campaigns(g, e)
    g = _framework_campaign(name, cd, device=cuda, test_data=test,
                            eval_every=1, rounds=2, **kw)
    cpu = _framework_campaign(name, cd, device="cpu", test_data=test,
                              eval_every=1, rounds=2, **kw)
    np.testing.assert_allclose(g.losses, cpu.losses, rtol=0, atol=1e-5)
    for i in range(2):
        assert _flipped_units(g.params_for(i), cpu.params_for(i)) <= 4
        for pg, pc in zip(g.params_for(i)[0], cpu.params_for(i)[0]):
            for k in pg:
                torch.testing.assert_close(pg[k].cpu(), pc[k], rtol=0,
                                           atol=1e-4)
    np.testing.assert_allclose(g.accuracy_per_round, cpu.accuracy_per_round,
                               rtol=0, atol=1.0 / len(test[1]) + 1e-9)


@pytest.mark.parametrize("name", list(_BASELINES))
def test_baseline_trainer_equals_seed_0_of_its_campaign(cuda, name):
    """The trainer with seed 0 on the card is seed 0 of its graphed
    campaign (the policy seed) at 1e-5: the same weights and batches."""
    from repro_torch.core import baselines
    cd, test = _campaign_data()
    cls, kw = _BASELINES[name]
    res = _framework_campaign(name, cd, device=cuda, **kw)
    tr = getattr(baselines, cls)(DNN10, SystemParams(M=12, seed=0), cd, test,
                                 seed=0, device=cuda, **kw)
    for _ in range(3):
        tr.run_round()
    hist = tr.fetch_history()
    np.testing.assert_allclose(res.losses[0, :, 0],
                               [m.client_loss for m in hist], rtol=0,
                               atol=1e-5)
    for pg, pt in zip(res.params_for(0)[0], tr.params):
        for k in pg:
            torch.testing.assert_close(pg[k], pt[k], rtol=0, atol=1e-5)
    assert [m.n_selected for m in res.metrics] == \
        [m.n_selected for m in hist]


@pytest.mark.parametrize("name,scenario", [("splitme", "straggler:0.4"),
                                           ("fedora", "fading"),
                                           ("fedavg", "churn:0.5")])
def test_scenario_campaign_graphed_equals_eager_and_cpu(cuda, name,
                                                        scenario):
    """A campaign under a time-varying RAN: the realized schedule is the
    CPU's, graphed equals eager bit for bit, and the card the CPU at
    1e-5."""
    cd, test = _campaign_data()
    kw = dict(_BASELINES.get(name, (None, {}))[1], scenario=scenario)
    g = _framework_campaign(name, cd, device=cuda, test_data=test,
                            eval_every=1, eval_gamma=10.0,
                            strict_transfers=True, **kw)
    e = _framework_campaign(name, cd, device=cuda, scan=False, **kw)
    _same_campaigns(g, e)
    cpu = _framework_campaign(name, cd, device="cpu", **kw)
    np.testing.assert_array_equal(g.schedule.a, cpu.schedule.a)
    assert g.schedule.trace is not None
    np.testing.assert_allclose(g.losses, cpu.losses, rtol=0, atol=1e-5)


def _same_guarded(a, b):
    """Two campaigns equal bit for bit, NaN crash rows and guard flags
    included."""
    np.testing.assert_array_equal(a.losses, b.losses)
    for i in range(len(a.seeds)):
        for ha, hb in zip(a.params_for(i), b.params_for(i)):
            for pa, pb in zip(ha, hb):
                assert all(torch.equal(pa[k], pb[k]) for k in pa)
    qa, qb = (quantcomm.tree_leaves(r.qstate) for r in (a, b))
    assert len(qa) == len(qb) and all(torch.equal(u, v)
                                      for u, v in zip(qa, qb))
    for f in ("skipped_per_round", "quorum_per_round", "crashed_per_round"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("name,kw", [
    ("splitme", {}), ("fedavg", dict(_BASELINES["fedavg"][1])),
    ("fedavg", dict(_BASELINES["fedavg"][1], quant="int8"))],
    ids=["splitme", "fedavg", "fedavg-int8"])
def test_fault_campaign_graphed_equals_uncaptured(cuda, name, kw):
    """A ``faults:0.3`` campaign on the card (guards armed by the faults,
    strict transfers, one host transfer): its graphs equal the same round
    bodies run without capture bit for bit (params, NaN crash rows, flags,
    error-feedback state), and the CPU's flags exactly, its losses at
    1e-5 over the rounds before the first wire flip lands."""
    cd, test = _campaign_data()
    kw = dict(kw, scenario="faults:0.3", scenario_seed=1, rounds=6,
              test_data=test, eval_every=2, eval_gamma=10.0)
    campaign.HOST_TRANSFERS = 0
    g = _framework_campaign(name, cd, device=cuda, strict_transfers=True,
                            **kw)
    assert campaign.HOST_TRANSFERS == 1
    assert g.skipped_per_round is not None and g.graphs["graphs"] > 0
    u = _framework_campaign(name, cd, device=cuda, _graphs=False, **kw)
    assert u.graphs["graphs"] == 0
    _same_guarded(g, u)
    cpu = _framework_campaign(name, cd, device="cpu", **kw)
    for f in ("skipped_per_round", "quorum_per_round", "crashed_per_round"):
        np.testing.assert_array_equal(getattr(g, f), getattr(cpu, f))
    np.testing.assert_array_equal(np.isnan(g.losses), np.isnan(cpu.losses))
    trace = g.schedule.trace
    gain = trace.wire_gain * g.schedule.a
    flip = np.flatnonzero((gain != 0) & (gain != 1.0)).tolist()
    early = slice(0, (flip[0] // 12) + 1 if flip else None)
    np.testing.assert_allclose(g.losses[:, early], cpu.losses[:, early],
                               rtol=0, atol=1e-5)


def test_checkpoint_resume_on_the_card_is_bit_exact(cuda, tmp_path):
    """A checkpointed SplitMe ``faults:0.3`` campaign aborted at round 4,
    resumed from its checkpoint (fresh graphs captured), equals the
    uninterrupted campaign bit for bit."""
    from repro_torch.launch import resilience
    cd, test = _campaign_data()
    kw = dict(scenario="faults:0.3", scenario_seed=1, rounds=6,
              test_data=test, eval_every=2, eval_gamma=10.0, device=cuda)
    ref = _framework_campaign("splitme", cd, **kw)

    def abort(cursor):
        if cursor >= 4:
            raise resilience.CampaignAborted(f"abort at {cursor}")
    with pytest.raises(resilience.CampaignAborted):
        _framework_campaign("splitme", cd, checkpoint_every=2,
                            checkpoint_dir=tmp_path, _checkpoint_hook=abort,
                            **kw)
    assert resilience.latest_checkpoint(tmp_path).name == "ckpt-r000004"
    res = resilience.resume_campaign(
        "splitme", DNN10, SystemParams(M=12, seed=0), cd,
        checkpoint_dir=tmp_path, checkpoint_every=2, seeds=(0, 1), **kw)
    _same_guarded(res, ref)
    assert [repr(m) for m in res.metrics] == [repr(m) for m in ref.metrics]
    assert np.isnan(res.round_ms[:4]).all() and res.graphs["graphs"] > 0


# population mode: the graphed population campaign
# ---------------------------------------------------------------------------

def _population_data():
    X, y = oran.generate(n_per_class=300, seed=0)
    return oran.train_test_split(X, y)


def _population(name, size, device, **kw):
    from repro_torch.core import population as popn
    (Xtr, ytr), test = _population_data()
    kw = dict(dict(rounds=6, seeds=(0, 1), cohort=16, samples_per_client=32,
                   test_data=test, eval_every=2, eval_gamma=10.0,
                   scenario="churn:0.5", K=4, E=3), **kw)
    return campaign.run_population_campaign(
        name, DNN10, popn.Population(size, seed=0), (Xtr, ytr),
        device=device, **kw)


@pytest.mark.parametrize("name,kw", [
    ("splitme", {}), ("fedavg", {}), ("splitme", dict(quant="int8")),
    ("fedavg", dict(quant="int8", guards=engine.RoundGuards(clip_norm=1.0)))],
    ids=["splitme", "fedavg", "splitme-int8", "fedavg-int8-clip"])
def test_population_campaign_graphed_equals_uncaptured_and_cpu(cuda, name,
                                                               kw):
    """A population campaign over 10^6 clients (cohort 16, ``churn:0.5``)
    on the card: strict transfers and one host transfer, one graph a round
    shape plus the evaluation's, the graphs equal to the same bodies run
    uncaptured bit for bit (params, losses, error-feedback state, flags),
    and the CPU's params and losses at 1e-5 over its first 3 rounds (the
    baselines' SGD amplifies last-bit differences later) and SplitMe's
    over all 6, its accuracy within one test sample; on the int8 wire at
    6e-2, the wire's bound (a last-bit difference moves a stochastic
    rounding by a grid step, as in ``chip_smoke.py`` phase 3c)."""
    tol = 6e-2 if kw.get("quant") == "int8" else 1e-5
    campaign.HOST_TRANSFERS = 0
    g = _population(name, 10 ** 6, cuda, strict_transfers=True, **kw)
    assert campaign.HOST_TRANSFERS == 1
    assert g.graphs["graphs"] == len(g.graphs["shapes"]) + 1
    assert g.schedule.ids.max() > 10 ** 4
    u = _population(name, 10 ** 6, cuda, _graphs=False, **kw)
    assert u.graphs["graphs"] == 0
    _same_guarded(g, u)
    rounds = 6 if name == "splitme" else 3
    card = g if rounds == 6 else _population(name, 10 ** 6, cuda,
                                             rounds=rounds, **kw)
    cpu = _population(name, 10 ** 6, "cpu", rounds=rounds, **kw)
    np.testing.assert_allclose(card.losses, cpu.losses, rtol=0, atol=tol)
    for pc, pu in zip(quantcomm.tree_leaves(card.params),
                      quantcomm.tree_leaves(cpu.params)):
        torch.testing.assert_close(pc.cpu(), pu, rtol=0, atol=tol)
    if name == "splitme":
        n_test = len(_population_data()[1][1])
        np.testing.assert_allclose(card.accuracy_per_round,
                                   cpu.accuracy_per_round, rtol=0,
                                   atol=1.0 / n_test + 1e-9)


def test_full_population_cohort_equals_materialized_on_the_card(cuda):
    """The full-population cohort (12 clients, cohort 12) equals
    ``run_campaign`` on the same rows and shards at 1e-5 on the card."""
    from repro_torch.core import population as popn
    (Xtr, ytr), test = _population_data()
    pop = popn.Population(12, seed=0)
    kw = dict(rounds=4, seeds=(0, 1), test_data=test, eval_every=2,
              eval_gamma=10.0, device=cuda)
    p = campaign.run_population_campaign("splitme", DNN10, pop, (Xtr, ytr),
                                         cohort=12, samples_per_client=32,
                                         **kw)
    ids = np.arange(12)
    m = campaign.run_campaign("splitme", DNN10, pop.system_params(ids),
                              pop.sample_shards(Xtr, ytr, ids, 32), **kw)
    np.testing.assert_array_equal(p.schedule.a, m.schedule.a)
    np.testing.assert_allclose(p.losses, m.losses, rtol=0, atol=1e-5)
    for a, b in zip(quantcomm.tree_leaves(p.params),
                    quantcomm.tree_leaves(m.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    np.testing.assert_allclose(p.accuracy_per_round, m.accuracy_per_round,
                               rtol=0, atol=1e-5)


def test_population_resume_on_the_card_is_bit_exact(cuda, tmp_path):
    """A checkpointed population campaign aborted at round 4 and resumed
    equals the uninterrupted one bit for bit."""
    from repro_torch.launch import resilience
    ref = _population("splitme", 10 ** 6, cuda)

    def abort(cursor):
        if cursor >= 4:
            raise resilience.CampaignAborted(f"abort at {cursor}")
    with pytest.raises(resilience.CampaignAborted):
        _population("splitme", 10 ** 6, cuda, checkpoint_every=2,
                    checkpoint_dir=tmp_path, _checkpoint_hook=abort)
    res = _population("splitme", 10 ** 6, cuda, checkpoint_every=2,
                      checkpoint_dir=tmp_path, resume=True)
    _same_guarded(res, ref)
    assert [repr(m) for m in res.metrics] == [repr(m) for m in ref.metrics]
    assert np.isnan(res.round_ms[:4]).all() and res.graphs["graphs"] > 0


# the config sweep: (variant, seed) pairs of their own cohorts and E
# ---------------------------------------------------------------------------

_SWEEP_B = (0.5e9, 1e9, 2e9)


def _sweep(name, cd, device, **kw):
    kw = dict(dict(rounds=4, seeds=(0, 1)), **kw)
    return campaign.run_config_sweep(
        name, DNN10, [SystemParams(M=12, seed=0, B=b) for b in _SWEEP_B], cd,
        device=device, **kw)


@pytest.mark.parametrize("name,kw", [
    ("splitme", {}), ("oranfed", dict(E=3)),
    ("fedavg", dict(_BASELINES["fedavg"][1], quant="int8"))],
    ids=["splitme", "oranfed", "fedavg-int8"])
def test_sweep_graphed_equals_uncaptured(cuda, name, kw):
    """The sweep on the card (strict transfers, one host transfer, one
    graph a round shape and one for the evaluation over the pairs) equals
    the same bodies run uncaptured bit for bit, each variant's params,
    losses, error-feedback state and accuracy; SplitMe's launches its
    KL and Gram kernels."""
    cd, test = _campaign_data()
    kw = dict(kw, test_data=test, eval_every=2, eval_gamma=10.0)
    kl_ops.launches = kl_ops.launches_bwd = rg_ops.launches = 0
    campaign.HOST_TRANSFERS = 0
    g = _sweep(name, cd, cuda, strict_transfers=True, **kw)
    assert campaign.HOST_TRANSFERS == 1
    launched = (kl_ops.launches, kl_ops.launches_bwd, rg_ops.launches)
    assert all(launched) if name == "splitme" else not any(launched)
    assert g[0].graphs["graphs"] == len(g[0].graphs["shapes"]) + 1
    u = _sweep(name, cd, cuda, _graphs=False, **kw)
    assert u[0].graphs["graphs"] == 0
    for a, b in zip(g, u):
        _same_campaigns(a, b)
        np.testing.assert_array_equal(a.accuracy_per_round,
                                      b.accuracy_per_round)


@pytest.mark.parametrize("name,kw,rounds", [("splitme", {}, 3),
                                            ("oranfed", dict(E=3), 2)])
def test_sweep_on_card_matches_cpu(cuda, name, kw, rounds):
    """The sweep on the card against the CPU on the same draws over its
    first rounds, by ``chip_smoke.py`` phase 3d's gates: losses at 1e-5,
    params at 1e-5 but for the weights of at most 4 hidden units a seed,
    within 1e-4, accuracy within one test sample.  SplitMe over 3 rounds;
    O-RANFed over 2, as test_graphed_baseline_campaign_equals_eager_and_cpu
    holds the baselines: on an H100 its own campaign at B 2e9, outside the
    sweep, parted from the CPU by 2.3e-5 (3 hidden units) after 2 rounds
    and 1.6e-4 (6 units) after 3."""
    cd, test = _campaign_data()
    kw = dict(kw, rounds=rounds, test_data=test, eval_every=1,
              eval_gamma=10.0)
    card = _sweep(name, cd, cuda, **kw)
    cpu = _sweep(name, cd, "cpu", **kw)
    for g, c in zip(card, cpu):
        np.testing.assert_array_equal(g.schedule.a, c.schedule.a)
        np.testing.assert_allclose(g.losses, c.losses, rtol=0, atol=1e-5)
        for i in range(2):
            assert _flipped_units(g.params_for(i), c.params_for(i)) <= 4
            for pg, pc in zip(quantcomm.tree_leaves(g.params_for(i)),
                              quantcomm.tree_leaves(c.params_for(i))):
                torch.testing.assert_close(pg.cpu(), pc, rtol=0, atol=1e-4)
        np.testing.assert_allclose(g.accuracy_per_round,
                                   c.accuracy_per_round, rtol=0,
                                   atol=1.0 / len(test[1]) + 1e-9)


def test_int8_sweep_on_card_matches_cpu(cuda):
    """FedAvg's sweep on the int8 wire (a scale and an error-feedback state
    a pair) on the card against the CPU: params and losses at the wire's
    6e-2, as the population campaign's card test holds them (a last-bit
    difference moves a stochastic rounding by a grid step: on an H100 one
    step of the first layer, 8.3e-3, after the first round)."""
    cd, test = _campaign_data()
    kw = dict(_BASELINES["fedavg"][1], quant="int8", rounds=3)
    card = _sweep("fedavg", cd, cuda, **kw)
    cpu = _sweep("fedavg", cd, "cpu", **kw)
    for g, c in zip(card, cpu):
        assert len(quantcomm.tree_leaves(g.qstate)) > 0
        np.testing.assert_allclose(g.losses, c.losses, rtol=0, atol=6e-2)
        for a, b in zip(quantcomm.tree_leaves(g.params),
                        quantcomm.tree_leaves(c.params)):
            torch.testing.assert_close(a.cpu(), b, rtol=0, atol=6e-2)


# ---------------------------------------------------------------------------
# the sharded campaign on one card: a process group of this process alone
# ---------------------------------------------------------------------------

@pytest.fixture()
def process_group(tmp_path):
    """``init(backend)`` starts a process group of this process alone (its
    store a file under ``tmp_path``); it is destroyed after the test."""
    import torch.distributed as dist

    def init(backend):
        dist.init_process_group(backend, init_method=f"file://{tmp_path}/pg",
                                world_size=1, rank=0)
    yield init
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("name,kw", [
    ("splitme", {}), ("fedavg", dict(K=4, E=3, quant="int8")),
    ("splitme", dict(quant="bf16")),
    ("splitme", dict(scenario="faults:0.3", scenario_seed=1))],
    ids=["splitme", "fedavg-int8", "splitme-bf16wire", "splitme-faults"])
def test_sharded_campaign_graphed_on_nccl(cuda, process_group, name, kw):
    """A 1-shard NCCL mesh: the campaign's rounds with their all-reduce
    captured in the graphs (strict transfers, one host transfer) equal the
    same bodies uncaptured bit for bit (params, losses, error-feedback
    state, flags, accuracy), the uncaptured run makes one all-reduce a
    round and one a server layer an evaluation, and the campaign equals
    the gathered one at 1e-5, its accuracy within 1e-6."""
    from repro_torch.launch import mesh as meshes
    process_group("nccl")
    mesh = meshes.make_client_mesh(1)
    cd, test = _campaign_data()
    kw = dict(kw, test_data=test, eval_every=2, eval_gamma=10.0)
    run = lambda **more: campaign.run_campaign(  # noqa: E731
        name, DNN10, SystemParams(M=12, seed=0), cd, rounds=3, seeds=(0, 1),
        device=cuda, **kw, **more)
    campaign.HOST_TRANSFERS = 0
    g = run(mesh=mesh, strict_transfers=True)
    assert campaign.HOST_TRANSFERS == 1
    assert all(kb == 12 for kb, _ in g.graphs["shapes"])
    before = engine.ALL_REDUCES
    u = run(mesh=mesh, _graphs=False)
    # 3 rounds; SplitMe's Step 4 after rounds 1 and 2, 8 server layers
    assert engine.ALL_REDUCES - before == 3 + (2 * 8 if name == "splitme"
                                               else 0)
    _same_guarded(g, u)
    np.testing.assert_array_equal(g.accuracy_per_round, u.accuracy_per_round)
    gathered = run()
    tol = 1e-5 if "quant" not in kw else {"bf16": 2e-2, "int8": 6e-2}[
        kw["quant"]]
    np.testing.assert_allclose(g.losses, gathered.losses, rtol=0, atol=tol)
    for a, b in zip(quantcomm.tree_leaves(g.params),
                    quantcomm.tree_leaves(gathered.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=tol)


def test_gloo_mesh_on_the_card_runs_uncaptured_only(cuda, process_group):
    """A gloo mesh carries card tensors, but its all-reduce waits on the
    host: a graphed campaign on it raises, an uncaptured one equals the
    gathered campaign at 1e-5; a ``cuda`` mesh on a gloo group raises."""
    from repro_torch.launch import mesh as meshes
    process_group("gloo")
    with pytest.raises(RuntimeError, match="nccl"):
        meshes.make_client_mesh(1)
    mesh = meshes.make_client_mesh(1, device_type="cpu")
    cd, test = _campaign_data()
    run = lambda **more: campaign.run_campaign(  # noqa: E731
        "splitme", DNN10, SystemParams(M=12, seed=0), cd, rounds=3,
        seeds=(0, 1), device=cuda, test_data=test, eval_gamma=10.0, **more)
    with pytest.raises(ValueError, match="cannot be captured"):
        run(mesh=mesh)
    u = run(mesh=mesh, _graphs=False)
    g = run()
    np.testing.assert_allclose(u.losses, g.losses, rtol=0, atol=1e-5)
    for a, b in zip(quantcomm.tree_leaves(u.params),
                    quantcomm.tree_leaves(g.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    np.testing.assert_allclose(u.accuracy, g.accuracy, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# zoo training (the bounds of tests/test_torch_train.py, reasons there)
# ---------------------------------------------------------------------------

_TRAIN_ARCHS = ("smollm-135m", "deepseek-v3-671b", "granite-moe-3b-a800m",
                "seamless-m4t-medium", "rwkv6-1.6b", "zamba2-2.7b")


def _train_batches(cfg, n, device, B=2, S=32):
    g = torch.Generator().manual_seed(5)
    out = []
    for _ in range(n):
        b = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g)}
        if cfg.frontend:
            b["embeds"] = torch.randn(B, cfg.frontend_positions, cfg.d_model,
                                      generator=g)
        out.append({k: v.to(device) for k, v in b.items()})
    return out


def _trained(model, batches, optimizer="adamw", lr=3e-4):
    from repro_torch.runtime.steps import make_train_step
    init_state, train_step = make_train_step(model, optimizer, lr=lr)
    state, step = init_state()
    losses = []
    for b in batches:
        state, step, m = train_step(state, step, b)
        losses.append(m["loss"].item())
    return losses, {n: p.detach().cpu() for n, p in model.named_parameters()}


@pytest.mark.parametrize("arch", _TRAIN_ARCHS)
def test_train_step_on_card_matches_cpu(cuda, arch):
    """Two AdamW steps of a reduced f32 model (plain scans, remat on) from
    the same weights: losses at 1e-5, parameters within 2 lr a step; no
    scan or attention kernel launches."""
    cfg = get_config(arch).reduced()
    card = build_model(cfg, device=cuda, policy="reference")
    cpu = build_model(cfg, device="cpu", policy="reference")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    before = (fa_ops.launches, wkv_ops.launches, ssd_ops.launches)
    lc, pc = _trained(card, _train_batches(cfg, 2, cuda))
    assert before == (fa_ops.launches, wkv_ops.launches, ssd_ops.launches)
    lp, pp = _trained(cpu, _train_batches(cfg, 2, "cpu"))
    np.testing.assert_allclose(lc, lp, rtol=0, atol=1e-5)
    for n, w in pp.items():
        assert (pc[n] - w).abs().max().item() <= 2 * 3e-4 * 2, n


def test_remat_on_card_matches_no_remat(cuda):
    """remat and "dots" against no remat at the same weights: loss and
    gradients within 1e-6 relative (the embedding backward's atomics keep
    the card from bit equality)."""
    from repro_torch.runtime.steps import lm_loss
    cfg = get_config("qwen3-14b").reduced()
    model = build_model(cfg, device=cuda, remat=False)
    for p in model.parameters():
        p.requires_grad_(True)
    batch = _train_batches(cfg, 1, cuda, B=4, S=64)[0]
    ref = None
    for remat, policy in ((False, None), (True, None), (True, "dots")):
        model.remat, model.remat_policy = remat, policy
        for p in model.parameters():
            p.grad = None
        logits, extras = model.forward(batch)
        loss = lm_loss(cfg, logits, batch["tokens"], extras)
        loss.backward()
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        if ref is None:
            ref = (loss.item(), grads)
            continue
        assert abs(loss.item() - ref[0]) <= 1e-6 * abs(ref[0])
        for n, g in grads.items():
            scale = ref[1][n].abs().max().item()
            assert (g - ref[1][n]).abs().max().item() <= 1e-6 * scale, n


def test_train_step_refuses_kernel_scans_on_card(cuda):
    """A model on the card whose policy routes a scan to its kernel is
    refused; the kernel itself raises under autograd, and nothing runs on
    past it."""
    from repro_torch.runtime.steps import make_train_step
    for arch in ("rwkv6-1.6b", "zamba2-2.7b"):
        cfg = get_config(arch).reduced()
        model = build_model(cfg, device=cuda)
        with pytest.raises(ValueError, match="no backward"):
            make_train_step(model)
        for p in model.parameters():
            p.requires_grad_(True)
        with pytest.raises(RuntimeError, match="has no backward"):
            model.forward(_train_batches(cfg, 1, cuda)[0])

"""The port's CUDA kernels and trainer on the card.

These tests need an NVIDIA card with the CUDA toolkit (the kernels are built
from ``src/repro_torch/kernels/csrc`` at first use) and skip elsewhere.  This
file imports no jax, so it runs on a machine that has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.splitme_dnn import DNNConfig
from repro_torch.core.cost import SystemParams
from repro_torch.core.splitme import SplitMeTrainer
from repro_torch.data import oran
from repro_torch.kernels import dispatch
from repro_torch.kernels.kl_mutual import ops as kl_ops
from repro_torch.kernels.kl_mutual.ref import kl_rows_ref
from repro_torch.kernels.ridge_gram import ops as rg_ops
from repro_torch.kernels.ridge_gram.ref import gram_ref

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


@pytest.mark.parametrize("rows,d", [(1600, 256), (1000, 200), (7, 3),
                                    (33, 1000)])
@pytest.mark.parametrize("temp", [1.0, 2.0])
def test_kl_kernel_matches_plain(cuda, rows, d, temp):
    x, y = _normal(0, (rows, d), cuda, 3.0), _normal(1, (rows, d), cuda, 3.0)
    before = kl_ops.launches
    got = kl_ops.kl_rows(x, y, temp)
    assert kl_ops.launches == before + 1
    torch.testing.assert_close(got, kl_rows_ref(x, y, temp), rtol=1e-6,
                               atol=1e-5)


def test_kl_kernel_gradient_matches_plain(cuda):
    x, y = _normal(2, (50, 32, 256), cuda), _normal(3, (50, 32, 256), cuda)
    grads = {}
    for pol in ("kernel", "reference"):
        tx = x.clone().requires_grad_(True)
        loss = dispatch.kl_loss(tx, y, temperature=2.0, policy=pol)
        loss.sum().backward()
        grads[pol] = (loss.detach(), tx.grad)
    torch.testing.assert_close(grads["kernel"][0], grads["reference"][0],
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(grads["kernel"][1], grads["reference"][1],
                               rtol=0, atol=1e-7)


@pytest.mark.parametrize("n,d1,d2", [(4800, 257, 257), (4800, 257, 128),
                                     (4800, 17, 3), (777, 45, 19),
                                     (1, 1, 1), (70, 33, 65)])
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


def test_wrappers_refuse_mixed_devices(cuda):
    with pytest.raises(ValueError):
        kl_ops.kl_rows(torch.zeros(4, 4, device=cuda), torch.zeros(4, 4), 1.0)
    with pytest.raises(ValueError):
        rg_ops.gram(torch.zeros(4, 4, device=cuda), torch.zeros(4, 2))


def test_trainer_on_card_matches_cpu(cuda):
    X, y = oran.generate(n_per_class=200, seed=0)
    train, test = oran.train_test_split(X, y)
    clients = oran.partition_non_iid(*train, 10, 32, seed=0)
    cfg = DNNConfig(hidden=(64, 64, 32, 32, 16))
    runs = {}
    for dev in ("cuda", "cpu"):
        kl_ops.launches = rg_ops.launches = 0
        t = SplitMeTrainer(cfg, SystemParams(M=10, E_max=4), clients, test,
                           batch_size=8, e_initial=4, seed=0, device=dev)
        hist = [t.run_round(eval_acc=r == 1) for r in range(2)]
        t.fetch_history()
        runs[dev] = (t, hist, kl_ops.launches, rg_ops.launches)
    tc, hc, kl_n, rg_n = runs["cuda"]
    tp, hp, _, _ = runs["cpu"]
    assert kl_n == 2 * 2 * 4 and rg_n == 2 * 4
    for p, q in zip(tc.w_c + tc.w_s_inv, tp.w_c + tp.w_s_inv):
        for k in ("w", "b"):
            torch.testing.assert_close(p[k].cpu(), q[k], rtol=0, atol=1e-5)
    for a, b in zip(hc, hp):
        assert abs(a.client_loss - b.client_loss) <= 1e-5
        assert abs(a.server_loss - b.server_loss) <= 1e-5

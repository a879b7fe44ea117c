"""The port's Step-4 ridge solve (``inversion.ridge_solve``): the system
A0 + γI formed in f32, as the reference forms it, solved by LU in f64.

``tests/data/step4_singular_layer.npz`` holds the Grams (A0 = OᵀO, A1 =
OᵀZ) of layer 5 of a trained DNN10's Step 4 at the default γ = 1e-3 (the
port's SplitMe campaign at the example's setting, seed 5 of seeds (4, 5,
0), after 20 rounds; 22 of its 64 input units dead).  On this system an
f32 LU with MKL's elimination order meets an exactly zero pivot and
returns NaN weights, which collapsed the evaluated accuracy to chance on 2
to 9 of 32 seeds (tests/torch_horizon_check.py seeds), while the
reference's ``jnp.linalg.solve`` returns finite weights and never
collapsed.  Bounds: f64 LAPACK on the same f32 system at 1e-6 of the
largest weight (both solve it in f64); the f32 solve of a well-conditioned
system at 1e-5 of the largest weight (cond ~1e2, f32 LU error ~1e-5
relative at most).
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.core import inversion
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

DATA = Path(__file__).resolve().parent / "data" / "step4_singular_layer.npz"
GAMMA = 1e-3


def _system():
    z = np.load(DATA)
    return z["a0"], z["a1"]


def _f32_system(a0, gamma):
    return (a0 + np.float32(gamma) * np.eye(len(a0), dtype=np.float32))


def test_ridge_solve_finite_where_the_reference_is_on_a_trained_layer():
    a0, a1 = _system()
    got = inversion.ridge_solve(torch.from_numpy(a0), torch.from_numpy(a1),
                                GAMMA)
    assert got.dtype == torch.float32 and got.shape == a1.shape
    assert bool(torch.isfinite(got).all())
    a = _f32_system(a0, GAMMA)
    want = np.linalg.solve(a.astype(np.float64), a1.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    # the reference on the same f32 system: finite too
    assert bool(jnp.isfinite(jnp.linalg.solve(jnp.asarray(a),
                                              jnp.asarray(a1))).all())


def test_ridge_solve_keeps_the_f32_solution_when_well_conditioned():
    rng = np.random.default_rng(0)
    o = rng.normal(size=(400, 33)).astype(np.float32)
    z = rng.normal(size=(400, 3)).astype(np.float32)
    a0, a1 = o.T @ o, o.T @ z
    got = inversion.ridge_solve(torch.from_numpy(a0), torch.from_numpy(a1),
                                10.0)
    want = torch.linalg.solve(torch.from_numpy(_f32_system(a0, 10.0)),
                              torch.from_numpy(a1)).numpy()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())

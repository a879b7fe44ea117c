"""Package rules of the port: it never imports jax or the JAX package, its
entry points refuse to run without a card unless asked for the CPU, and the
chip smoke script fails cleanly where there is no card or no repository."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def _port_files():
    return sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py",
        ROOT / "scripts" / "crash_resume_check_torch.py",
        ROOT / "scripts" / "chip_sharded_check_torch.py"]


def test_port_files_exist():
    names = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    for want in ("configs/splitme_dnn.py", "data/oran.py", "core/cost.py",
                 "core/selection.py", "core/allocation.py", "core/dnn.py",
                 "core/mutual.py", "core/engine.py", "core/inversion.py",
                 "core/splitme.py", "kernels/build.py", "kernels/dispatch.py",
                 "kernels/kl_mutual/ops.py", "kernels/kl_mutual/ref.py",
                 "kernels/ridge_gram/ops.py", "kernels/ridge_gram/ref.py",
                 "convert.py", "configs/base.py", "configs/rwkv6_1p6b.py",
                 "configs/zamba2_2p7b.py", "models/common.py",
                 "models/attention.py", "models/rwkv6.py", "models/mamba2.py",
                 "models/transformer.py", "kernels/rwkv6_wkv/ops.py",
                 "kernels/rwkv6_wkv/ref.py", "kernels/mamba2_scan/ops.py",
                 "kernels/mamba2_scan/ref.py", "runtime/steps.py",
                 "serve.py", "kernels/flash_attention/ops.py",
                 "kernels/flash_attention/ref.py", "launch/campaign.py",
                 "core/quantcomm.py", "core/baselines.py",
                 "core/scenario.py", "checkpoint/io.py",
                 "launch/resilience.py", "core/population.py",
                 "examples/oran_splitfl_campaign.py", "examples/quickstart.py",
                 "launch/mesh.py", "core/distributed.py", "models/moe.py",
                 "models/mla.py", "configs/smollm_135m.py",
                 "configs/qwen3_14b.py", "configs/granite_20b.py",
                 "configs/nemotron_4_15b.py", "configs/internvl2_1b.py",
                 "configs/granite_moe_3b_a800m.py",
                 "configs/deepseek_v3_671b.py",
                 "configs/seamless_m4t_medium.py", "optim/optimizers.py",
                 "optim/schedules.py", "examples/lm_pretrain.py",
                 "sharding/partition.py", "launch/specs.py",
                 "launch/dryrun.py", "launch/roofline_run.py",
                 "launch/fl_dryrun.py", "roofline/analysis.py"):
        assert want in names
    assert (ROOT / "chip_smoke.py").is_file()
    for src in ("common.cu", "kl_mutual.cu", "ridge_gram.cu", "rwkv6_wkv.cu",
                "mamba2_scan.cu", "flash_attention_mma.cu",
                "flash_attention_tf32.cu"):
        assert (PORT / "kernels" / "csrc" / src).is_file()


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_imports(path):
    bad = [(mod, line) for mod, line in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _tiny_trainer_args():
    from repro_torch.configs.splitme_dnn import DNNConfig
    from repro_torch.core.cost import SystemParams
    rng = np.random.default_rng(0)
    clients = {"x": rng.normal(size=(4, 8, 30)).astype(np.float32),
               "y": rng.integers(0, 3, (4, 8)).astype(np.int32)}
    test = (rng.normal(size=(6, 30)).astype(np.float32),
            rng.integers(0, 3, 6).astype(np.int32))
    return DNNConfig(hidden=(8, 8, 4)), SystemParams(M=4, E_max=2), \
        clients, test


def test_trainer_without_device_needs_a_card():
    from repro_torch.core.splitme import SplitMeTrainer
    from repro_torch.device import resolve_device
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SplitMeTrainer(*_tiny_trainer_args(), batch_size=4, e_initial=2)
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(ValueError):
        resolve_device("meta")
    t = SplitMeTrainer(*_tiny_trainer_args(), batch_size=4, e_initial=2,
                       device="cpu")
    assert t.x.device.type == "cpu"


def test_population_campaign_without_device_needs_a_card():
    from repro_torch.configs.splitme_dnn import DNNConfig
    from repro_torch.core.population import Population
    from repro_torch.launch.campaign import run_population_campaign
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    rng = np.random.default_rng(0)
    pool = (rng.normal(size=(30, 30)).astype(np.float32),
            np.arange(30) % 3)
    kw = dict(rounds=1, seeds=(0,), cohort=4, samples_per_client=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_population_campaign("fedavg", DNNConfig(hidden=(8,)),
                                Population(10 ** 6), pool, **kw)
    res = run_population_campaign("fedavg", DNNConfig(hidden=(8,)),
                                  Population(10 ** 6), pool, device="cpu",
                                  **kw)
    assert res.params[0][0]["w"].device.type == "cpu"


def test_config_sweep_without_device_needs_a_card():
    from repro_torch.configs.splitme_dnn import DNNConfig
    from repro_torch.core.cost import SystemParams
    from repro_torch.launch.campaign import run_config_sweep
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    cfg, sp, clients, test = _tiny_trainer_args()
    sps = [sp, SystemParams(M=4, E_max=2, B=2e9)]
    kw = dict(rounds=1, seeds=(0,), K=2, E=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_config_sweep("fedavg", cfg, sps, clients, **kw)
    res = run_config_sweep("fedavg", cfg, sps, clients, device="cpu", **kw)
    assert [r.params[0][0]["w"].device.type for r in res] == ["cpu", "cpu"]


def test_examples_without_device_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for name, argv in (("quickstart", ["--rounds", "1"]),
                       ("oran_splitfl_campaign", ["--rounds", "1"]),
                       ("lm_pretrain", ["--reduced", "--steps", "1"])):
        out = subprocess.run(
            [sys.executable, "-m", f"repro_torch.examples.{name}", *argv],
            env=env, capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert "device='cpu'" in out.stderr


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-2.7b"])
def test_build_model_without_device_needs_a_card(arch):
    from repro_torch.configs.base import get_config
    from repro_torch.models.transformer import build_model
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    cfg = get_config(arch).reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    assert build_model(cfg, device="cpu").device.type == "cpu"


def test_serve_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.serve"],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr
    assert "tok/s" not in out.stdout


def test_trainer_rejects_unported_options():
    from repro_torch.core.splitme import SplitMeTrainer
    # a serial trainer needs a built trace, not a name (as the reference)
    with pytest.raises(TypeError, match="ScenarioTrace"):
        SplitMeTrainer(*_tiny_trainer_args(), device="cpu", scenario="fading")
    with pytest.raises(ValueError, match="Corollary 3"):
        SplitMeTrainer(*_tiny_trainer_args(), device="cpu", lr_c=0.01,
                       lr_s=0.02)


def test_convert_round_trip():
    from repro_torch.convert import params_from_numpy, params_to_numpy
    rng = np.random.default_rng(0)
    layers = [{"w": rng.normal(size=(3, 4)), "b": rng.normal(size=4)}]
    got = params_from_numpy(layers, device="cpu")
    assert got[0]["w"].dtype == torch.float32
    back = params_to_numpy(got)
    np.testing.assert_array_equal(back[0]["w"],
                                  layers[0]["w"].astype(np.float32))
    np.testing.assert_array_equal(back[0]["b"],
                                  layers[0]["b"].astype(np.float32))


def _run_smoke(cwd: Path):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_trainer_rejects_out_of_range_indices():
    from repro_torch.core.splitme import SplitMeTrainer
    cfg, sp, clients, test = _tiny_trainer_args()
    t = SplitMeTrainer(cfg, sp, clients, test, batch_size=4, e_initial=2,
                       device="cpu", index_source=lambda r: torch.full(
                           (2, 4, 2, 4), 8, dtype=torch.int64))
    with pytest.raises(ValueError, match="batch indices"):
        t.run_round()

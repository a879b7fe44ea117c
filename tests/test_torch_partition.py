"""The port's partition rules (``repro_torch.sharding.partition``) against
the JAX package's (``repro.sharding.partition``).

The rules read only the mesh's axis sizes, so both sides take them from a
mapping (the reference from a stand-in with ``shape`` and
``axis_names``): no device and no process group.  The placements and a
sharded model run in a subprocess on a fake world
(tests/torch_tooling_check.py).

Every leaf of the ten zoo configs at full width (abstract shapes on both
sides: ``jax.eval_shape`` and the ``meta`` device) gets the reference's
spec with its stacked layer dims dropped, for fsdp on and off and
expert_parallel False / True / "megatron"; the per-layer vectors are the
one exception (ROADMAP C), shown by ``test_stacked_vectors_differ``.
"""
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import pytest
from hypothesis import given, settings, strategies as st

from repro.configs.base import INPUT_SHAPES as REF_SHAPES
from repro.configs.base import get_config as ref_config
from repro.models.transformer import build_model as ref_build
from repro.sharding import partition as rp
from repro_torch.configs.base import get_config, list_configs
from repro_torch.convert import layer_stacks
from repro_torch.models.transformer import build_abstract_model
from repro_torch.sharding import partition as tp
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"2x16x16": {"pod": 2, "data": 16, "model": 16},
          "16x16": {"data": 16, "model": 16}}
ARCHS = [a for a in list_configs() if a != "splitme-dnn10"]
EP = [False, True, "megatron"]


def ref_mesh(sizes):
    return types.SimpleNamespace(shape=dict(sizes), axis_names=tuple(sizes))


def ref_spec(path, shape, sizes, **kw):
    return tuple(rp.param_spec(path, types.SimpleNamespace(shape=shape),
                               ref_mesh(sizes), **kw))


@settings(max_examples=300, deadline=None)
@given(rows=st.integers(1, 4096), cols=st.integers(1, 4096),
       mesh=st.sampled_from(sorted(MESHES)), fsdp=st.booleans(),
       ep=st.sampled_from(EP), lead=st.sampled_from([(), (8,), (16, 3)]),
       path=st.sampled_from(["w", "layers/moe/experts/w_up",
                             "layers/moe/experts/w_down"]))
def test_param_spec_matches_jax(rows, cols, mesh, fsdp, ep, lead, path):
    """(…, rows, cols) with rows, cols ≤ 4096 on both production meshes."""
    sizes = MESHES[mesh]
    shape = lead + (rows, cols)
    assert tp.param_spec(path, shape, sizes, fsdp=fsdp,
                         expert_parallel=ep) == ref_spec(
        path, shape, sizes, fsdp=fsdp, expert_parallel=ep)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("dp_over_model", [False, True])
def test_batch_spec_matches_jax(mesh, dp_over_model):
    """The reference's global batches (1, 32, 128, 256), with and without
    the model axis, for token, activation and embedding shapes."""
    sizes = MESHES[mesh]
    for s in REF_SHAPES.values():
        for shape in ((s.global_batch, s.seq_len), (s.global_batch, 1),
                      (s.global_batch, 8, 1024)):
            assert tp.batch_spec(shape, sizes,
                                 dp_over_model=dp_over_model) == tuple(
                rp.batch_spec(shape, ref_mesh(sizes),
                              dp_over_model=dp_over_model))


def test_scalar_and_vector_specs():
    sizes = MESHES["16x16"]
    for shape in ((), (7,), (4096,)):
        assert tp.param_spec("x", shape, sizes) == ref_spec("x", shape, sizes)
    assert tp.replicated(0) == tuple(rp.P()) == ()
    assert tp.axis_sizes(sizes) == sizes


@pytest.fixture(scope="module")
def zoo_leaves():
    """{arch: (the port's {key: shape}, the reference's {path: stacked
    shape})}, every zoo config at full width, abstract on both sides."""
    out = {}
    for arch in ARCHS:
        model = build_abstract_model(get_config(arch))
        port = {k: tuple(p.shape) for k, p in model.named_parameters()}
        abs_params = jax.eval_shape(ref_build(ref_config(arch)).init,
                                    jax.random.PRNGKey(0))
        ref = {"/".join(str(k.key) for k in path): tuple(leaf.shape)
               for path, leaf in
               jax.tree_util.tree_flatten_with_path(abs_params)[0]}
        out[arch] = (port, ref)
    return out


def _stacked(cfg, key, shape):
    stacks = layer_stacks(cfg)
    head = key.split(".")[0]
    return tuple(stacks.get(head, ())) + tuple(shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_zoo_leaf_paths_match_jax(zoo_leaves, arch):
    """Every port leaf maps onto one reference leaf (``param_path``), with
    the reference's stacked shape, and every reference leaf is covered."""
    cfg = get_config(arch)
    port, ref = zoo_leaves[arch]
    seen = {}
    for key, shape in port.items():
        path = tp.param_path(cfg, key)
        assert path in ref, (arch, key, path)
        seen.setdefault(path, set()).add(_stacked(cfg, key, shape))
    assert set(seen) == set(ref)
    for path, shapes in seen.items():
        assert shapes == {ref[path]}, (arch, path)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_zoo_specs_match_jax(zoo_leaves, arch, mesh):
    """fsdp on / off × expert_parallel False / True / "megatron": every
    leaf of two or more dims a layer gets the reference's spec of its
    stacked leaf with the stacked dims dropped (and the stacked dims
    there are never sharded); the vectors replicate."""
    cfg = get_config(arch)
    sizes = MESHES[mesh]
    port, _ = zoo_leaves[arch]
    n_vec = 0
    for fsdp in (True, False):
        for ep in EP:
            for key, shape in port.items():
                path = tp.param_path(cfg, key)
                got = tp.param_spec(path, shape, sizes, fsdp=fsdp,
                                    expert_parallel=ep)
                full = _stacked(cfg, key, shape)
                want = ref_spec(path, full, sizes, fsdp=fsdp,
                                expert_parallel=ep)
                lead = len(full) - len(shape)
                if len(shape) >= 2:
                    assert want[:lead] == (None,) * lead, (key, want)
                    assert got == want[lead:], (arch, key, fsdp, ep)
                else:
                    assert got == (None,) * len(shape)
                    n_vec += 1
    assert n_vec > 0


def test_stacked_vectors_differ(zoo_leaves):
    """The reference caveat (ROADMAP C): on a stacked (L, d) vector the
    reference's matrix rule splits the layer dim over the FSDP axes and d
    over "model"; the port's per-layer (d,) vector replicates.  These are
    exactly the leaves whose specs differ, and ``stacked_vector_leaves``
    lists them."""
    sizes = MESHES["16x16"]
    differing = {}
    for arch in ARCHS:
        cfg = get_config(arch)
        model = build_abstract_model(cfg)
        listed = tp.stacked_vector_leaves(cfg, model.named_parameters())
        port, _ = zoo_leaves[arch]
        for key, shape in port.items():
            path = tp.param_path(cfg, key)
            full = _stacked(cfg, key, shape)
            want = ref_spec(path, full, sizes)
            lead = len(full) - len(shape)
            got = tp.param_spec(path, shape, sizes)
            differs = (got != want[lead:]
                       or any(a is not None for a in want[:lead]))
            if differs:
                differing[(arch, path)] = want
            # the listed leaves differ exactly where the reference shards
            assert differs == (path in listed
                               and any(a is not None for a in want)), path
            if path in listed:
                assert listed[path] == full
    assert differing
    # Qwen3-14B's (40, 5120) norm scales: d on "model" in the reference
    assert differing[("qwen3-14b", "layers/ln1")] == (None, "model")
    assert tp.param_spec("layers/ln1", (5120,), sizes) == (None,)
    # Zamba2's (9, 6, 2560) Mamba2 norm scales: 6 on neither FSDP axis
    assert differing[("zamba2-2.7b", "mamba/ln")] == (None, None, "model")


@pytest.fixture(scope="module")
def sharded():
    out = Path(os.environ.get("TMPDIR", "/tmp")) / f"part_{os.getpid()}.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, str(ROOT / "tests" /
                                        "torch_tooling_check.py"),
                    "partition", str(out)], check=True, env=env,
                   timeout=600, capture_output=True)
    try:
        return json.loads(out.read_text())
    finally:
        out.unlink()


def test_placements_row_major(sharded):
    """A dim split over ("pod", "data") takes two ``Shard(d)``, pod outer
    and data inner; the other mesh dims replicate."""
    assert sharded["placements"] == {
        "(None, None)": ["R", "R", "R"],
        "(('pod', 'data'), 'model')": ["S0", "S0", "S1"],
        "('data', None)": ["R", "S0", "R"],
        "(None, ('pod', 'data'))": ["S1", "S1", "R"],
        "('model', ('pod', 'data'))": ["S1", "S1", "S0"]}


def test_shard_params_local_shapes(sharded):
    """Qwen3-14B on the 2 × 16 × 16 fake world: each parameter's local
    shard is its shape divided by the axes its spec names; the batch of
    256 splits 32 ways."""
    sizes = MESHES["2x16x16"]
    for key, full in sharded["full"].items():
        spec = sharded["specs"][key]
        want = []
        for n, axes in zip(full, spec):
            axes = [axes] if isinstance(axes, str) else (axes or [])
            div = 1
            for a in axes:
                div *= sizes[a]
            want.append(n // div)
        assert sharded["local"][key] == want, key
    assert sharded["batch_local"] == [8, 4096]

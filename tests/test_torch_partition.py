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


# ---------------------------------------------------------------------------
# The dry-run's reshards and its flattened 2 x 16 x 16 mesh
# ---------------------------------------------------------------------------

def _standin(shape, placements, mesh_shape):
    """What ``partition._uneven_for_view`` reads of a DTensor."""
    mesh = types.SimpleNamespace(ndim=len(mesh_shape),
                                 mesh=types.SimpleNamespace(shape=mesh_shape))
    return types.SimpleNamespace(shape=shape, placements=placements,
                                 device_mesh=mesh)


def test_view_groups():
    assert tp._view_groups((128, 1, 576), (128, 1, 9, 64)) == [
        ([0], [0]), ([1], [1]), ([2], [2, 3])]
    assert tp._view_groups((4, 8, 3, 64), (4, 8, 192)) == [
        ([0], [0]), ([1], [1]), ([2, 3], [2])]
    assert tp._view_groups((40, 6, 8), (240, 8)) == [([0, 1], [0]),
                                                     ([2], [1])]


@pytest.mark.parametrize("shape,placements,mesh,view,bad", [
    # 9 heads of 64 over a "model" axis of 16: refused by DTensor
    ((128, 1, 576), ("P", "S2"), (16, 16), (128, 1, 9, 64), [1]),
    # 48 heads split 16 ways evenly: kept
    ((128, 1, 6144), ("S0", "S2"), (16, 16), (128, 1, 48, 128), []),
    # 48 heads regrouped into 8 KV heads of 6: 8 does not split 16 ways
    ((2, 4, 48, 128), ("S0", "S2"), (2, 16), (2, 4, 8, 6, 128), [1]),
    # Granite-20B's one KV head: the groups (48) take the shard
    ((2, 4, 48, 128), ("S0", "S2"), (2, 16), (2, 4, 1, 48, 128), []),
    # 40 experts over 16: an uneven dim merged
    ((40, 64, 32), ("S0", "R"), (16, 16), (2560, 32), [0]),
    # a shard on the inner dim of a merge would be strided
    ((4, 8, 3, 64), ("R", "S3"), (1, 2), (4, 8, 192), [1]),
    # the batch split over one dim of 32 and the heads merged back
    ((256, 16, 40, 128), ("S0", "R"), (32, 16), (256, 16, 5120), []),
    # the MoE's 32 x 32768 tokens over both mesh dims back to (b, s):
    # gathered over "model" alone, the 32 rows then split 16 ways
    ((1048576, 7168), ("S0", "S0"), (16, 16), (32, 32768, 7168), [1]),
    # ... and over both when neither divides
    ((4096, 7168), ("S0", "S0"), (16, 16), (2, 2048, 7168), [0, 1]),
])
def test_uneven_for_view(shape, placements, mesh, view, bad):
    from torch.distributed.tensor import Partial, Replicate, Shard
    make = {"P": Partial(), "R": Replicate()}
    pls = tuple(make.get(p) or Shard(int(p[1:])) for p in placements)
    assert tp._uneven_for_view(_standin(shape, pls, mesh), view) == bad


def test_reshape_of_a_plain_tensor_is_reshape():
    import torch
    x = torch.arange(24.0).reshape(2, 12)
    for shape in ((2, 3, 4), (2, -1, 2), (24,)):
        y = tp.reshape(x, *shape)
        assert y.shape == x.reshape(shape).shape
        assert y.data_ptr() == x.data_ptr() and torch.equal(
            y, x.reshape(shape))
    assert tp.fsdp_gathered(x) is x
    assert tp.replicated_like(x, x) is x and tp.laid_out_like(x, x) is x


class _FoldedMesh:
    """What ``axis_sizes`` and ``placements`` read of the dry-run's 2 × 16
    × 16 mesh (``launch.mesh.make_dryrun_mesh(multi_pod=True)``): 32 × 16
    ranks, ("pod", "data") folded into its "data" dim."""
    mesh_dim_names = ("data", "model")
    mesh = types.SimpleNamespace(shape=(32, 16))
    folded = {"data": {"pod": 2, "data": 16}}


def test_pod_apart():
    """On the folded mesh a spec splits "pod" and "data" together or is
    refused; the production axes are what the rules see."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = _FoldedMesh()
    assert tp.axis_sizes(mesh) == MESHES["2x16x16"]
    assert tp.placements((("pod", "data"), "model"), mesh) == [Shard(0),
                                                               Shard(1)]
    assert tp.placements((("pod", "data", "model"), None), mesh) == [
        Shard(0), Shard(0)]
    assert tp.placements((None, None), mesh) == [Replicate(), Replicate()]
    for spec in (("data", None), (None, "pod"), (("data", "model"), None)):
        with pytest.raises(ValueError, match="alone"):
            tp.placements(spec, mesh)


@pytest.mark.parametrize("arch", ARCHS)
def test_zoo_keeps_pod_and_data_together(arch):
    """Every parameter spec of the default rules (fsdp, no expert
    parallelism) on the folded mesh is the 2 × 16 × 16 mesh's, and splits
    "pod" and "data" together, so the folded mesh lays them all out."""
    model = build_abstract_model(get_config(arch))
    named = list(model.named_parameters())
    specs = tp.param_specs(model.cfg, named, _FoldedMesh())
    assert specs == tp.param_specs(model.cfg, named, MESHES["2x16x16"])
    for spec in specs.values():
        tp.placements(spec, _FoldedMesh())


@pytest.mark.parametrize("ep,apart", [(False, False), ("megatron", True)])
def test_dryrun_refuses_pod_apart(ep, apart):
    """The dry-run's 2 × 16 × 16 mesh holds "pod" and "data" as one dim:
    a combination whose rules split "data" alone (Megatron-style experts)
    is refused where its specs become placements, not laid out
    otherwise."""
    model = build_abstract_model(get_config("granite-moe-3b-a800m"))
    specs = tp.param_specs(model.cfg, model.named_parameters(),
                           _FoldedMesh(), expert_parallel=ep)
    if apart:
        with pytest.raises(ValueError, match="alone"):
            for spec in specs.values():
                tp.placements(spec, _FoldedMesh())
    else:
        for spec in specs.values():
            tp.placements(spec, _FoldedMesh())


def test_cache_vectors_replicate():
    sizes = MESHES["16x16"]
    assert tp.cache_spec((32768,), sizes) == (None,)
    assert tp.cache_spec((128, 32768, 8, 128), sizes) == ("data", None,
                                                           None, None)
    assert tp.cache_spec((128, 32768, 16, 128), sizes) == ("data", None,
                                                            "model", None)


@pytest.fixture(scope="module")
def rule_values(tmp_path_factory):
    out = tmp_path_factory.mktemp("rule_values") / "values.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, str(ROOT / "tests" /
                                               "torch_tooling_check.py"),
                           "rule-values", str(out)], env=env, timeout=600,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads(out.read_text())


VALUE_CASES = [f"moe-forward-{m}" for m in ("2x1", "1x2")] + [
    f"heads-decode-{m}-step{i}" for m in ("2x1", "1x2") for i in range(3)]


@pytest.mark.parametrize("case", VALUE_CASES)
def test_rules_compute_the_plain_values(rule_values, case):
    """A reduced Granite-MoE forward and three decode steps of a reduced
    config with 3 heads, on a gloo job of 2 CPU processes with DTensor
    parameters (the batch over 2, or the heads' "model" axis of 2), equal
    the plain single-process run at 1e-6 of the output's scale: the rules
    and reshards compute the right numbers, not just the right shapes."""
    err, scale = rule_values[case]
    assert scale > 0 and err <= 1e-6 * scale

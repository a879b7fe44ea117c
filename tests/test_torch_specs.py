"""The dry-run's abstract inputs (``repro_torch.launch.specs``, the
``meta`` device) against the JAX package's (``repro.launch.specs``,
``jax.eval_shape``): every leaf's shape and dtype of the parameters, the
train / prefill batch and the decode cache, for the ten zoo configs at
full width and depth × the four input shapes.

The port keeps one tensor a layer where JAX stacks the layers
(``convert.layer_stacks``): a port leaf is compared stacked, and a cache
list of per-layer NamedTuples as JAX's stacked NamedTuple.  The ring
buffer's write offset is a host integer in the port (``KVCache.index``),
a stacked int32 leaf in JAX: the one leaf only JAX has.
"""
import jax

import pytest
import torch

from repro.configs.base import INPUT_SHAPES as REF_SHAPES
from repro.launch import specs as rs
from repro_torch.configs.base import INPUT_SHAPES, list_configs
from repro_torch.convert import layer_stacks
from repro_torch.launch import specs as ts
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

ARCHS = [a for a in list_configs() if a != "splitme-dnn10"]
SHAPES = list(INPUT_SHAPES)


def _dt(d) -> str:
    return str(d).replace("torch.", "")


def _key(k) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def jax_leaves(tree) -> dict:
    return {"/".join(_key(k) for k in path): (tuple(l.shape), _dt(l.dtype))
            for path, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_leaves(tree, prefix=""):
    """{path: (shape, dtype)} of the port's tree, a list of layers stacked
    on a leading dim; host integers as (None, "host")."""
    if isinstance(tree, torch.Tensor):
        return {prefix: (tuple(tree.shape), _dt(tree.dtype))}
    if isinstance(tree, int):
        return {prefix: (None, "host")}
    if isinstance(tree, list):
        parts = [port_leaves(v, prefix) for v in tree]
        assert all(p.keys() == parts[0].keys() for p in parts)
        out = {}
        for k in parts[0]:
            assert len({p[k] for p in parts}) == 1, k
            shape, dt = parts[0][k]
            out[k] = (None if shape is None else (len(tree),) + shape, dt)
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        items = tree.items()
    out = {}
    for k, v in items:
        out.update(port_leaves(v, f"{prefix}/{k}".strip("/")))
    return out


def stacked_params(cfg, named) -> dict:
    stacks = layer_stacks(cfg)
    out = {}
    for key, t in named.items():
        parts = key.split(".")
        dims = stacks.get(parts[0])
        if dims is None:
            out["/".join(parts)] = (tuple(t.shape), _dt(t.dtype))
            continue
        path = "/".join([parts[0]] + parts[2:])
        out.setdefault(path, [dims, set()])[1].add(
            (tuple(t.shape), _dt(t.dtype)))
    for path, v in out.items():
        if isinstance(v, list):
            (shape, dt), = v[1]
            out[path] = (tuple(v[0]) + shape, dt)
    return out


def same_stacked(want, got) -> bool:
    """JAX's (G, g, …) stack against the port's flat (G·g, …) list."""
    if want == got:
        return True
    return (len(want) == len(got) + 1
            and (want[0] * want[1],) + tuple(want[2:]) == tuple(got))


@pytest.fixture(scope="module")
def ref_params():
    cache = {}

    def get(arch):
        if arch not in cache:
            model, _ = rs.build_for(arch, "train_4k")
            cache[arch] = jax_leaves(rs.abstract_params(model))
        return cache[arch]
    return get


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_inputs_match_jax(ref_params, arch, shape):
    model, s = ts.build_for(arch, shape)
    assert s == INPUT_SHAPES[shape]
    assert (s.name, s.seq_len, s.global_batch, s.kind) == (
        REF_SHAPES[shape].name, REF_SHAPES[shape].seq_len,
        REF_SHAPES[shape].global_batch, REF_SHAPES[shape].kind)
    params = ts.abstract_params(model)
    assert all(p.device.type == "meta" for p in params.values())
    assert stacked_params(model.cfg, params) == ref_params(arch)
    jm, js = rs.build_for(arch, shape)
    assert ts.decode_window_for(model.cfg, s) == rs.decode_window_for(
        jm.cfg, js)
    if s.kind in ("train", "prefill"):
        want = {k: (tuple(v.shape), _dt(v.dtype))
                for k, v in rs.batch_specs(jm.cfg, js).items()}
        got = {k: (tuple(v.shape), _dt(v.dtype))
               for k, v in ts.batch_specs(model.cfg, s).items()}
        assert got == want
        return
    jp = rs.abstract_params(jm)
    want = jax_leaves(rs.abstract_cache(jm, js, jp))
    got = port_leaves(ts.abstract_cache(model, s))
    tensors = {k: v for k, v in got.items() if v[1] != "host"}
    assert set(want) - set(tensors) == {k for k in want
                                        if k.endswith("index")}
    for k, (shape_, dt) in tensors.items():
        assert k in want, k
        assert dt == want[k][1], k
        assert same_stacked(want[k][0], shape_), (k, want[k], shape_)
    assert all(t.device.type == "meta" for t in
               jax.tree_util.tree_leaves(ts.abstract_cache(model, s))
               if isinstance(t, torch.Tensor))


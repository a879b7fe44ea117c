"""Sharded parity harness of the port (the counterpart of
tests/sharded_parity_check.py): the JAX package's sharded round and mesh
campaign on a 4-device CPU mesh, and the port's on a gloo job of 4 CPU
processes (or a 2 x 2 ``pod`` x ``data`` job), on the same draws.

    python tests/torch_sharded_check.py jax OUT PART
        (with XLA_FLAGS=--xla_force_host_platform_device_count=4)
    python tests/torch_sharded_check.py port OUT IN DATA [POD]
    python tests/torch_sharded_check.py wire OUT.json

Both read the same inputs: the JAX run makes them itself
(``shared_inputs``), the port's reads them from ``IN``, a pickle that also
holds its campaign draws (``campaign_inputs``: the JAX package's initial
params, replayed batch indices and per-shard int8 uniforms).  Each run
writes its results as a pickle of numpy trees, the port's one a rank
(``OUT.<rank>``).  tests/test_torch_sharded.py starts the runs and
compares them.

``wire`` measures how far the wires summed on 4 shards part from one
device over the paper's 30 rounds, in each package on its own draws: the
campaign of ``scripts/chip_sharded_check_torch.py`` (SplitMe, DNN10,
``SystemParams(M=100)``, ``oran.generate(n_per_class=4000, seed=0)``, 96
samples a client, seeds 0-3, Step 4 every 10 rounds at γ 10) on the bf16
and the int8 wire, on JAX's 4-device CPU mesh against its single device
(``wire-jax``, under ``--xla_force_host_platform_device_count=4``) and on
the port's gloo job of 4 CPU ranks against one CPU device (``wire-port``),
each checkpointed after every round.  It writes, round by round, the
largest |Δ params| and |Δ loss| of 4 shards against 1 per wire and
package to OUT.json.
"""
import json
import os
import pickle
import sys
import tempfile

import numpy as np

N_SHARDS = 4
# the round: M clients of N samples, batch B, E_MAX steps of which E run
ROUND = dict(M=8, N=16, B=8, E_MAX=4, E=3, KEY=7, INIT=3)
ROUND_CASES = [(fw, None) for fw in ("splitme", "fedavg", "sfl", "oranfed",
                                     "fedora", "ecofl")] + [
    ("splitme", "bf16"), ("fedavg", "int8"), ("splitme", "int8")]
# the campaign: tests/test_torch_sweep.py's size
CFG_KW = dict(hidden=(32, 16), split_index=1)
CAMP = dict(M=12, N=24, B=32, SEEDS=(0, 1), ROUNDS=3, E_CAP=20)
CAMP_KW = dict(K=4, E=3, eval_every=2, eval_gamma=10.0)
CAMPAIGN_CASES = [(fw, {}) for fw in ("splitme", "fedavg", "sfl", "oranfed",
                                      "fedora", "ecofl")] + [
    ("splitme", {"quant": "bf16"}), ("fedavg", {"quant": "int8"}),
    ("splitme", {"quant": "int8"}),
    ("splitme", {"scenario": "faults:0.3", "scenario_seed": 1})]
# the cases of the 2 x 2 job
POD_ROUNDS = [("splitme", None), ("fedavg", "int8")]
POD_CAMPAIGNS = [0, 7]
# Step 4 on the mesh: one client a shard, enough samples for a full rank
INV = dict(M=4, N=160, GAMMA=1.0)


def case_id(fw, kw) -> str:
    return fw + "".join(f"-{v}" for v in kw.values())


def n_phases(fw) -> int:
    return 2 if fw == "splitme" else 1


# ---------------------------------------------------------------------------
# inputs (made by the test module, which imports both packages)
# ---------------------------------------------------------------------------

def shared_inputs() -> dict:
    """What both runs read and each makes alike (JAX on the CPU, numpy):
    the campaign's clients and test split; the round's data and mask, and
    per round case the initial params and the draws of its key (indices,
    each shard's int8 uniforms, a nonzero error-feedback state); Step 4's
    inputs."""
    import jax
    from repro.configs.splitme_dnn import DNNConfig as JDNNConfig
    from repro.core import dnn as jdnn
    from repro.core import engine as jengine
    from repro.data import oran
    from torch_parity import replay_round_indices, replay_round_uniforms

    jcfg = JDNNConfig(**CFG_KW)
    X, y = oran.generate(n_per_class=300, seed=0)
    (Xtr, ytr), test = oran.train_test_split(X, y)
    cd = oran.partition_non_iid(Xtr, ytr, CAMP["M"],
                                samples_per_client=CAMP["N"], seed=0)
    rng = np.random.default_rng(0)
    M, N = ROUND["M"], ROUND["N"]
    a = rng.integers(0, 2, M).astype(np.float32)
    a[0] = 1.0
    inp = {"round": {
        "x": rng.normal(size=(M, N, 30)).astype(np.float32),
        "y": rng.integers(0, 3, (M, N)).astype(np.int32), "a": a},
        "campaign_data": ({k: np.asarray(v) for k, v in cd.items()},
                          tuple(np.asarray(v) for v in test))}
    key = jax.random.PRNGKey(ROUND["KEY"])
    for fw, quant in ROUND_CASES:
        spec = jengine.make_spec(fw, jcfg)
        params = jax.device_get(spec.init_fn(jax.random.PRNGKey(
            ROUND["INIT"])))
        trained = {ph.param_idx: params[ph.param_idx] for ph in spec.phases}
        case = {"params": params, "idx": replay_round_indices(
            key, n_phases(fw), M, ROUND["E_MAX"], ROUND["B"], N)}
        if quant == "int8":
            case["u"] = [replay_round_uniforms(key, trained, s)
                         for s in range(N_SHARDS)]
            case["qstate"] = jax.tree.map(
                lambda l: (0.01 * rng.normal(size=(N_SHARDS,) + l.shape))
                .astype(np.float32), trained)
        inp[("round", fw, quant)] = case
    w_c = jdnn.init_client(jax.random.PRNGKey(0), jcfg)
    r3 = np.random.default_rng(3)
    x = r3.normal(size=(INV["M"], INV["N"], 30)).astype(np.float32)
    inp["inversion"] = {
        "w_i": jax.device_get(jdnn.init_inverse_server(
            jax.random.PRNGKey(1), jcfg)),
        "smashed": np.asarray(jax.vmap(
            lambda xm: jdnn.client_forward(w_c, xm, jcfg))(x)),
        "y1": np.eye(3, dtype=np.float32)[
            r3.integers(0, 3, (INV["M"], INV["N"]))]}
    return inp


def campaign_inputs(inp: dict) -> dict:
    """The port's campaign draws, added to ``inp``: per campaign case the
    JAX campaign's initial params, the indices of every (seed, round) at
    E_CAP steps (a bucket's draw is their prefix) and, under int8, each
    shard's uniforms (S, R, shards, U)."""
    import jax
    from repro.configs.splitme_dnn import DNNConfig as JDNNConfig
    from torch_parity import (jax_initial_params, replay_round_indices,
                              replay_round_uniforms)

    jcfg = JDNNConfig(**CFG_KW)
    subs = []
    for s in CAMP["SEEDS"]:
        k, row = jax.random.PRNGKey(s), []
        for _ in range(CAMP["ROUNDS"]):
            k, sub = jax.random.split(k)
            row.append(sub)
        subs.append(row)
    for fw, kw in CAMPAIGN_CASES:
        init = jax_initial_params(fw, jcfg, CAMP["SEEDS"])
        case = {"params": init, "idx": np.stack([np.stack([
            replay_round_indices(sub, n_phases(fw), CAMP["M"],
                                 CAMP["E_CAP"], CAMP["B"], CAMP["N"])
            for sub in row]) for row in subs])}
        if kw.get("quant") == "int8":
            trained = {i: init[0][i] for i in range(n_phases(fw))}
            case["u"] = np.stack([np.stack([np.stack([
                replay_round_uniforms(sub, trained, sh)
                for sh in range(N_SHARDS)]) for sub in row])
                for row in subs])
        inp[("campaign", case_id(fw, kw))] = case
    return inp


# ---------------------------------------------------------------------------
# the JAX package on a 4-device CPU mesh, in two parts run side by side
# ---------------------------------------------------------------------------

# part 0: the rounds, Step 4 and four baseline campaigns; part 1: the rest
JAX_PARTS = (list(range(2, 6)), [0, 1] + list(range(6, len(CAMPAIGN_CASES))))


def run_jax(inp, part: int) -> dict:
    import jax
    import jax.numpy as jnp
    from repro.configs.splitme_dnn import DNNConfig as JDNNConfig
    from repro.core import engine as jengine
    from repro.core.cost import SystemParams as JSystemParams
    from repro.core.distributed import make_distributed_inversion
    from repro.launch import campaign as jcampaign
    from repro.launch.mesh import make_cpu_mesh

    assert jax.device_count() >= N_SHARDS, jax.device_count()
    jcfg = JDNNConfig(**CFG_KW)
    mesh = make_cpu_mesh(N_SHARDS)
    out = {}
    if part == 0:
        rd = inp["round"]
        x, y, a = (jnp.asarray(rd[k]) for k in ("x", "y", "a"))
        for fw, quant in ROUND_CASES:
            case = inp[("round", fw, quant)]
            spec = jengine.make_spec(fw, jcfg, batch_size=ROUND["B"],
                                     masked_loss_metric=True, quant=quant)
            params = jax.tree.map(jnp.asarray, case["params"])
            qs = jengine.init_quant_state(spec, params, n_shards=N_SHARDS)
            if quant == "int8":
                qs = jax.tree.map(jnp.asarray, case["qstate"])
            rf = jengine.build_sharded_round_fn(
                spec, jcfg, mesh, n_clients=ROUND["M"],
                e_max=ROUND["E_MAX"], donate=False)
            p, l, q = rf(params, x, y, a, jnp.asarray(ROUND["E"]),
                         jax.random.PRNGKey(ROUND["KEY"]), qs)
            out[("round", fw, quant)] = jax.device_get(
                {"params": p, "losses": [float(v) for v in l], "qstate": q})
        inv = inp["inversion"]
        out["inversion"] = jax.device_get(jax.jit(make_distributed_inversion(
            jcfg, mesh, gamma=INV["GAMMA"]))(
            jax.tree.map(jnp.asarray, inv["w_i"]),
            jnp.asarray(inv["smashed"]), jnp.asarray(inv["y1"])))
    cd, test = inp["campaign_data"]
    for i in JAX_PARTS[part]:
        fw, kw = CAMPAIGN_CASES[i]
        res = jcampaign.run_campaign(
            fw, jcfg, JSystemParams(M=CAMP["M"], seed=0), cd,
            rounds=CAMP["ROUNDS"], seeds=CAMP["SEEDS"], test_data=test,
            mesh=mesh, **CAMP_KW, **kw)
        out[("campaign", case_id(fw, kw))] = _jax_result(res)
    return out


def _jax_result(res) -> dict:
    import jax
    got = {"params": jax.device_get(res.params), "losses": res.losses,
           "accuracy_per_round": res.accuracy_per_round,
           "a": res.schedule.a, "E": res.schedule.E}
    for k in ("skipped_per_round", "quorum_per_round", "crashed_per_round"):
        got[k] = getattr(res, k, None)
    return got


# ---------------------------------------------------------------------------
# the port on a gloo job
# ---------------------------------------------------------------------------

def _np(tree):
    import torch
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def _port_result(res) -> dict:
    return {"params": _np(res.params), "losses": res.losses,
            "accuracy_per_round": res.accuracy_per_round,
            "a": res.schedule.a, "E": res.schedule.E,
            "qstate": _np(res.qstate),
            "skipped_per_round": res.skipped_per_round,
            "quorum_per_round": res.quorum_per_round,
            "crashed_per_round": res.crashed_per_round}


def _sources(case, shard):
    """The campaign's index and uniform sources from the replayed draws."""
    idx, u = case["idx"], case.get("u")

    def index_source(i, r, eb):
        return idx[i, r][:, :, :eb]

    def uniform_source(i, r, sh=None):
        return u[i, r, shard if sh is None else sh]
    return index_source, (uniform_source if u is not None else None)


def _campaign(fw, kw, case, cd, test, mesh=None, **extra):
    import torch
    from repro_torch.configs.splitme_dnn import DNNConfig
    from repro_torch.core import engine
    from repro_torch.core.cost import SystemParams
    from repro_torch.launch import campaign
    shard = 0 if mesh is None else engine.shard_index(mesh)
    index_source, uniform_source = _sources(case, shard)
    params = [tuple([{k: torch.tensor(v) for k, v in layer.items()}
                     for layer in half] for half in seed)
              for seed in case["params"]]
    return campaign.run_campaign(
        fw, DNNConfig(**CFG_KW), SystemParams(M=CAMP["M"], seed=0), cd,
        rounds=CAMP["ROUNDS"], seeds=CAMP["SEEDS"], test_data=test,
        device="cpu", params=params, index_source=index_source,
        uniform_source=uniform_source, mesh=mesh, **CAMP_KW, **kw, **extra)


def _round(mesh, fw, quant, inp, single=False):
    import torch
    from repro_torch.configs.splitme_dnn import DNNConfig
    from repro_torch.convert import params_from_numpy, qstate_shard_from_numpy
    from repro_torch.core import engine
    cfg = DNNConfig(**CFG_KW)
    case, rd = inp[("round", fw, quant)], inp["round"]
    spec = engine.make_spec(fw, cfg, batch_size=ROUND["B"],
                            masked_loss_metric=True, quant=quant,
                            device="cpu")
    params = tuple(params_from_numpy(p, "cpu") for p in case["params"])
    x, y = torch.tensor(rd["x"]), torch.tensor(rd["y"]).long()
    a, idx = torch.tensor(rd["a"]), torch.tensor(case["idx"])
    shard = engine.shard_index(mesh)
    qs, u = engine.init_quant_state(spec, params), None
    if quant == "int8":
        qs = qstate_shard_from_numpy(case["qstate"], shard, "cpu", axis=0)
        u = torch.tensor(case["u"][shard])
    if single:
        rf = engine.build_round_fn(spec, cfg, x, y, e_max=ROUND["E_MAX"])
        return rf(params, a, ROUND["E"], idx, qs, u)
    rf = engine.build_sharded_round_fn(spec, cfg, mesh, n_clients=ROUND["M"],
                                       e_max=ROUND["E_MAX"])
    return rf(params, x, y, a, ROUND["E"], idx, qs, u)


def _raises(fn) -> str:
    try:
        fn()
    except Exception as e:              # the message the tests match
        return f"{type(e).__name__}: {e}"
    return "no error"


def port_rank(rank: int, world: int, pg_file: str, shape, in_path: str,
              out_path: str, tmp: str) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{pg_file}",
                            world_size=world, rank=rank)
    from repro_torch.configs.splitme_dnn import DNNConfig
    from repro_torch.core import engine
    from repro_torch.launch import campaign, mesh as meshes
    with open(in_path, "rb") as f:
        inp = pickle.load(f)
    mesh = meshes.make_client_mesh(*shape, device_type="cpu")
    pod = len(shape) == 2
    cfg = DNNConfig(**CFG_KW)
    cd, test = inp["campaign_data"]
    out = {"shard": engine.shard_index(mesh),
           "n_shards": engine.n_client_shards(mesh),
           "axes": engine.client_axes(mesh)}
    for fw, quant in (POD_ROUNDS if pod else ROUND_CASES):
        before = engine.ALL_REDUCES
        p, l, q = _round(mesh, fw, quant, inp)
        out[("round", fw, quant)] = {
            "params": _np(p), "losses": [float(v) for v in l],
            "qstate": _np(q), "all_reduces": engine.ALL_REDUCES - before}
        if rank == 0 and quant is None and not pod:
            p, l, _ = _round(mesh, fw, quant, inp, single=True)
            out[("single", fw)] = {"params": _np(p),
                                   "losses": [float(v) for v in l]}
    cases = ([CAMPAIGN_CASES[i] for i in POD_CAMPAIGNS] if pod
             else CAMPAIGN_CASES)
    for fw, kw in cases:
        cid = case_id(fw, kw)
        before = (engine.ALL_REDUCES, campaign.HOST_TRANSFERS)
        res = _campaign(fw, kw, inp[("campaign", cid)], cd, test, mesh=mesh)
        got = _port_result(res)
        got["all_reduces"] = engine.ALL_REDUCES - before[0]
        got["host_transfers"] = campaign.HOST_TRANSFERS - before[1]
        out[("campaign", cid)] = got
        if rank == 0 and not pod:
            out[("gathered", cid)] = _port_result(
                _campaign(fw, kw, inp[("campaign", cid)], cd, test))
    if not pod:
        _port_extras(rank, mesh, inp, cfg, cd, test, tmp, out)
    with open(f"{out_path}.{rank}", "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _port_extras(rank, mesh, inp, cfg, cd, test, tmp, out):
    """The 4-rank job's other cases: Step 4 on the mesh, a resumed int8
    campaign, the per-variant sweep, the raises."""
    import torch
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import distributed, engine
    from repro_torch.core.cost import SystemParams
    from repro_torch.core.inversion import invert_inverse_model
    from repro_torch.launch import campaign, mesh as meshes, resilience
    inv = inp["inversion"]
    w_i = params_from_numpy(inv["w_i"], "cpu")
    smashed, y1 = torch.tensor(inv["smashed"]), torch.tensor(inv["y1"])
    before = engine.ALL_REDUCES
    out["inversion"] = _np(distributed.make_distributed_inversion(
        cfg, mesh, gamma=INV["GAMMA"])(w_i, smashed, y1))
    out["inversion_all_reduces"] = engine.ALL_REDUCES - before
    if rank == 0:
        out["inversion_local"] = _np(invert_inverse_model(
            w_i, smashed.reshape(-1, smashed.shape[-1]),
            y1.reshape(-1, 3), cfg, gamma=INV["GAMMA"]))
    # a SplitMe round through the adapter: every client, E steps
    rd, case = inp["round"], inp[("round", "splitme", None)]
    rf = distributed.make_splitme_round(
        cfg, mesh, n_clients=ROUND["M"], samples_per_client=ROUND["N"],
        E=ROUND["E_MAX"], batch=ROUND["B"], device="cpu")
    w_c, w_s = (params_from_numpy(p, "cpu") for p in case["params"])
    y1r = torch.nn.functional.one_hot(torch.tensor(rd["y"]).long(), 3).float()
    out["adapter"] = _np(rf(w_c, w_s, torch.tensor(rd["x"]), y1r,
                            torch.tensor(case["idx"])))
    # resume: FedAvg on the int8 wire, default draws, saved every 4 rounds,
    # aborted at round 4 and resumed, against the campaign run through
    kw = dict(rounds=8, seeds=CAMP["SEEDS"], K=4, E=3, quant="int8",
              device="cpu", mesh=mesh)
    sp = SystemParams(M=CAMP["M"], seed=0)
    ref = campaign.run_campaign("fedavg", cfg, sp, cd, **kw)
    ck = os.path.join(tmp, "ckpt")

    def abort(r):
        if r >= 4:
            raise resilience.CampaignAborted(f"abort at round {r}")
    out["aborted"] = _raises(lambda: campaign.run_campaign(
        "fedavg", cfg, sp, cd, checkpoint_every=4, checkpoint_dir=ck,
        _checkpoint_hook=abort, **kw))
    found = resilience.latest_checkpoint(ck)
    out["checkpoint"] = None if found is None else found.name
    res = resilience.resume_campaign("fedavg", cfg, sp, cd,
                                     checkpoint_dir=ck, checkpoint_every=4,
                                     **kw)
    out["resume"] = {"ref": _port_result(ref), "resumed": _port_result(res)}
    if found is not None and rank == 0:
        from repro_torch.checkpoint import io
        out["checkpoint_qstate"] = io.load_arrays(found)
    # the per-variant sweep through the sharded campaign
    sps = [SystemParams(M=CAMP["M"], seed=0, B=b) for b in (0.5e9, 2e9)]
    skw = dict(rounds=CAMP["ROUNDS"], seeds=CAMP["SEEDS"], test_data=test,
               device="cpu", vmap_configs=False, **CAMP_KW)
    out["sweep"] = [_port_result(r) for r in campaign.run_config_sweep(
        "splitme", cfg, sps, cd, mesh=mesh, **skw)]
    if rank == 0:
        out["sweep_gathered"] = [_port_result(r) for r in
                                 campaign.run_config_sweep(
                                     "splitme", cfg, sps, cd, **skw)]
    # the raises: no collective runs before any of them
    spec = engine.make_spec("fedavg", cfg, device="cpu")
    odd = {"x": cd["x"][:10], "y": cd["y"][:10]}
    out["raises"] = {
        "divisible_round": _raises(lambda: engine.build_sharded_round_fn(
            spec, cfg, mesh, n_clients=10, e_max=2)),
        "divisible_campaign": _raises(lambda: campaign.run_campaign(
            "fedavg", cfg, SystemParams(M=10, seed=0), odd, rounds=1,
            seeds=(0,), device="cpu", mesh=mesh)),
        "cuda_mesh": _raises(lambda: meshes.make_client_mesh(
            N_SHARDS, device_type="cuda")),
        "world_size": _raises(lambda: meshes.make_client_mesh(
            N_SHARDS + 1, device_type="cpu")),
        "no_scan": _raises(lambda: campaign.run_campaign(
            "fedavg", cfg, sp, cd, rounds=1, seeds=(0,), device="cpu",
            mesh=mesh, scan=False)),
        "vmapped_sweep": _raises(lambda: campaign.run_config_sweep(
            "splitme", cfg, sps, cd, rounds=1, seeds=(0,), device="cpu",
            mesh=mesh)),
    }


# ---------------------------------------------------------------------------
# the wires on 4 shards against one device over 30 rounds (ROADMAP C 7)
# ---------------------------------------------------------------------------

WIRE = dict(M=100, N_PER_CLASS=4000, SEEDS=(0, 1, 2, 3), ROUNDS=30,
            EVAL_EVERY=10, GAMMA=10.0)
WIRE_QUANTS = ("bf16", "int8")


def wire_data():
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src"))
    from repro_torch.data import oran
    X, y = oran.generate(n_per_class=WIRE["N_PER_CLASS"], seed=0)
    (Xtr, ytr), test = oran.train_test_split(X, y)
    return oran.partition_non_iid(Xtr, ytr, WIRE["M"], samples_per_client=96,
                                  seed=0), test


def wire_curves(sharded_dir, single_dir, sharded_loss, single_loss) -> dict:
    """Round by round: the largest |Δ params| (from the checkpoints after
    every round) and |Δ loss| of the sharded campaign against the single
    device's."""
    from torch_horizon_check import checkpoint_params, max_param_diff
    a, b = checkpoint_params(sharded_dir), checkpoint_params(single_dir)
    R = WIRE["ROUNDS"]
    assert sorted(a) == sorted(b) == list(range(1, R + 1))
    dl = np.abs(np.asarray(sharded_loss) - np.asarray(single_loss))
    return {"params": [max_param_diff(a[r], b[r]) for r in range(1, R + 1)],
            "loss": [float(dl[:, r].max()) for r in range(R)]}


def _wire_kw(tmp, name):
    return dict(rounds=WIRE["ROUNDS"], seeds=WIRE["SEEDS"],
                eval_every=WIRE["EVAL_EVERY"], eval_gamma=WIRE["GAMMA"],
                checkpoint_every=1, checkpoint_dir=os.path.join(tmp, name))


def run_wire_jax(out_path) -> None:
    import jax
    from repro.configs.splitme_dnn import DNN10 as JDNN10
    from repro.core.cost import SystemParams as JSystemParams
    from repro.launch import campaign as jcampaign
    from repro.launch.mesh import make_cpu_mesh
    assert jax.device_count() >= N_SHARDS, jax.device_count()
    cd, test = wire_data()
    tmp = tempfile.mkdtemp(dir=os.path.dirname(os.path.abspath(out_path)))
    out = {}
    for quant in WIRE_QUANTS:
        runs = {}
        for name, mesh in (("sharded", make_cpu_mesh(N_SHARDS)),
                           ("single", None)):
            runs[name] = jcampaign.run_campaign(
                "splitme", JDNN10, JSystemParams(M=WIRE["M"], seed=0), cd,
                test_data=test, quant=quant, mesh=mesh,
                **_wire_kw(tmp, f"{quant}-{name}"))
        out[quant] = wire_curves(
            os.path.join(tmp, f"{quant}-sharded"),
            os.path.join(tmp, f"{quant}-single"),
            runs["sharded"].losses, runs["single"].losses)
    with open(out_path, "w") as f:
        json.dump(out, f)


def wire_port_rank(rank, world, pg_file, out_path, tmp) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{pg_file}",
                            world_size=world, rank=rank)
    from repro_torch.configs.splitme_dnn import DNN10
    from repro_torch.core.cost import SystemParams
    from repro_torch.launch import campaign, mesh as meshes
    mesh = meshes.make_client_mesh(world, device_type="cpu")
    cd, test = wire_data()
    out = {}
    for quant in WIRE_QUANTS:
        run = lambda name, **more: campaign.run_campaign(  # noqa: E731
            "splitme", DNN10, SystemParams(M=WIRE["M"], seed=0), cd,
            test_data=test, quant=quant, device="cpu",
            **_wire_kw(tmp, f"{quant}-{name}"), **more)
        sharded = run("sharded", mesh=mesh)
        if rank == 0:
            single = run("single")
            out[quant] = wire_curves(
                os.path.join(tmp, f"{quant}-sharded"),
                os.path.join(tmp, f"{quant}-single"),
                sharded.losses, single.losses)
        dist.barrier()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def run_wire(out_path) -> None:
    """Both packages' runs side by side, each a subprocess; their curves
    into OUT.json."""
    import subprocess
    here = os.path.abspath(__file__)
    root = os.path.dirname(os.path.dirname(here))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(root, "src"), os.path.dirname(here)]))
    jax_env = dict(env, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
    parts = {"jax": out_path + ".jax", "port": out_path + ".port"}
    procs = [subprocess.Popen([sys.executable, here, f"wire-{k}", v],
                              env=jax_env if k == "jax" else env)
             for k, v in parts.items()]
    for p in procs:
        if p.wait() != 0:
            raise SystemExit(f"{p.args[2]} exited {p.returncode}")
    out = {"setting": {k: list(v) if isinstance(v, tuple) else v
                       for k, v in WIRE.items()}}
    for k, v in parts.items():
        with open(v) as f:
            out[k] = json.load(f)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    shown = [r for r in (1, 3, 10, 20, 30) if r <= WIRE["ROUNDS"]]
    for quant in WIRE_QUANTS:
        for k in parts:
            c = out[k][quant]
            print(f"{quant} {k}: 4 shards vs 1 after rounds {shown}: params "
                  + ", ".join(f"{c['params'][r - 1]:.3e}" for r in shown)
                  + "; losses "
                  + ", ".join(f"{c['loss'][r - 1]:.3e}" for r in shown))


def run_port(in_path, out_path, shape) -> None:
    import torch.multiprocessing as mp
    world = int(np.prod(shape))
    tmp = tempfile.mkdtemp(dir=os.path.dirname(os.path.abspath(out_path)))
    mp.spawn(port_rank, args=(world, os.path.join(tmp, "pg"), shape,
                              in_path, out_path, tmp), nprocs=world)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    which, out_path = sys.argv[1:3]
    if which == "wire":
        run_wire(out_path)
    elif which == "wire-jax":
        run_wire_jax(out_path)
    elif which == "wire-port":
        import torch.multiprocessing as mp
        tmp = tempfile.mkdtemp(dir=os.path.dirname(os.path.abspath(
            out_path)))
        mp.spawn(wire_port_rank, args=(N_SHARDS, os.path.join(tmp, "pg"),
                                       out_path, tmp), nprocs=N_SHARDS)
    elif which == "jax":
        with open(out_path, "wb") as f:
            pickle.dump(run_jax(shared_inputs(), int(sys.argv[3])), f)
    else:
        run_port(sys.argv[3], out_path,
                 tuple(int(v) for v in sys.argv[4:]) or (N_SHARDS,))

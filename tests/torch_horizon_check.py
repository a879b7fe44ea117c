"""The paper's experiment at its full horizon in both packages, on the CPU:
the reference's own sensitivity to its last bit, and the distribution of
each framework's final accuracy over seeds, each package on its own draws.

    python tests/torch_horizon_check.py envelope OUT.json [FRAMEWORK ...]
    python tests/torch_horizon_check.py seeds OUT.json [--seeds N]
        [--threads T] [FRAMEWORK ...]
    python tests/torch_horizon_check.py reference OUT.json SEEDS.json ...
    python tests/torch_horizon_check.py merge OUT.json PART.json ...
    python tests/torch_horizon_check.py replay-jax OUT_DIR FRAMEWORK ...

The setting is the example's (examples/oran_splitfl_campaign.py --seeds
--baselines): ``oran.generate(n_per_class=2000, seed=0)``,
``train_test_split``, ``partition_non_iid(..., 50, samples_per_client=96,
seed=0)``, ``SystemParams(seed=0)``, DNN10, batch 32, SplitMe over 30
rounds and the baselines over 60 with the example's K and E, an evaluation
every 10 rounds and after the last.

``envelope`` runs the JAX package's campaign of seeds ``HORIZON_SEEDS``
once as it is and once under each of ``PERTURBATIONS`` of its initial
weights (``jnp.nextafter`` by one f32 ulp), SplitMe's evaluation at
``EVAL_GAMMA``, with an evaluation and a checkpoint after every round, and
writes round by round the largest parameter, loss and accuracy difference
of each perturbed run from the unperturbed one, and their maximum over the
four: the reference's envelope.  ``merge`` joins the envelopes of runs
made side by side (a framework or two a process) into one file,
``tests/data/horizon_envelope.json``, from which
tests/test_torch_horizon_*.py take their bounds (``bound``).

``seeds`` runs ``run_campaign`` of each framework over seeds 0 .. N-1 (32
by default) in the JAX package and in the port, each with its own draws
(threefry in the one, ``torch.Generator`` streams in the other), SplitMe's
evaluation at the example's default ridge, and prints each side's per-seed
final accuracies, their medians, the count below ``LOW_ACC``, the
two-sided Mann-Whitney p of the two samples and the two-sided Fisher exact
p of their counts below ``LOW_ACC`` (the port's finals depend on
its torch threads, ``--threads``: MKL sums in another order and the
trajectories are chaotic).  ``reference`` merges the results of ``seeds``
runs (one framework a process runs them side by side), prints the table
and writes the JAX side's finals to
``tests/data/horizon_reference.json``, which ``chip_smoke.py`` holds the
card's campaigns against.

``replay-jax`` runs the reference's side of the replayed parity runs
(``reference_replayed``) of each framework and pickles it to
``OUT_DIR/<framework>.pkl``: tests/test_torch_horizon_*.py start it in a
subprocess (``start_reference``) and run the port's side beside it.

The other modes write their results as JSON to OUT.json.
"""
import argparse
import contextlib
import dataclasses
import glob
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
REFERENCE_FILE = ROOT / "tests" / "data" / "horizon_reference.json"
ENVELOPE_FILE = ROOT / "tests" / "data" / "horizon_envelope.json"

# the example's frameworks, hyperparameters and horizons
FRAMEWORKS = {"splitme": {}, "fedavg": {"K": 10, "E": 10},
              "sfl": {"K": 20, "E": 14}, "oranfed": {"E": 10},
              "fedora": {"E": 10}, "ecofl": {"K": 10, "E": 10}}
SPLITME_ROUNDS, BASELINE_ROUNDS = 30, 60
M, N_PER_CLASS, SAMPLES, B = 50, 2000, 96, 32
EVAL_EVERY = 10
# the replayed parity runs and the envelope: seeds (0, 1), SplitMe's
# evaluation at a well-conditioned ridge (at 1e-3 the f32 solve is
# ill-conditioned: two correct solves of the same Grams classify apart)
HORIZON_SEEDS = (0, 1)
EVAL_GAMMA = 10.0
N_SEEDS = 32
# the largest E bucket of any round (SystemParams().E_max): each round's
# draw is the prefix of its draw at E_CAP steps
E_CAP = 20
LOW_ACC = 0.70
# seconds a test waits for the reference's replayed run of one framework
REPLAY_TIMEOUT = 900
# one f32 ulp of the initial params (``perturb``): every element (weights
# and biases) up, every element down, every other element up, the first
# layer up
PERTURBATIONS = ("all_up", "all_down", "alternate_up", "first_layer_up")


def rounds_of(fw: str) -> int:
    return SPLITME_ROUNDS if fw == "splitme" else BASELINE_ROUNDS


def n_phases(fw: str) -> int:
    return 2 if fw == "splitme" else 1


def campaign_data():
    """The example's clients and test split (numpy; the port's copy of
    ``oran`` gives the same arrays as the reference's)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.data import oran
    X, y = oran.generate(n_per_class=N_PER_CLASS, seed=0)
    (Xtr, ytr), test = oran.train_test_split(X, y)
    cd = oran.partition_non_iid(Xtr, ytr, M, samples_per_client=SAMPLES,
                                seed=0)
    return cd, test


def campaign_kw(fw: str, seeds, eval_every=EVAL_EVERY, gamma=EVAL_GAMMA):
    return dict(rounds=rounds_of(fw), seeds=tuple(seeds),
                eval_every=eval_every, eval_gamma=gamma, **FRAMEWORKS[fw])


def checkpoint_params(ckpt_dir) -> dict:
    """{round cursor: {leaf key: seed-stacked array}} of the params of every
    committed checkpoint in ``ckpt_dir`` (both packages write the same
    names: ``ckpt-r{cursor:06d}.npz``, leaves ``params/<half>/<layer>/<w|b>``
    stacked over seeds)."""
    out = {}
    for path in sorted(glob.glob(os.path.join(ckpt_dir, "ckpt-r*.npz"))):
        name = os.path.basename(path)[:-4]
        if name.endswith("-buffers"):
            continue
        data = np.load(path)
        out[int(name[len("ckpt-r"):])] = {
            k: data[k] for k in data.files if k.startswith("params/")}
    return out


def max_param_diff(a: dict, b: dict) -> float:
    assert a.keys() == b.keys(), (sorted(a), sorted(b))
    return max(float(np.max(np.abs(a[k].astype(np.float64)
                                   - b[k].astype(np.float64))))
               for k in a)


def nan_max(v) -> float:
    v = np.asarray(v, np.float64)
    return float(np.nanmax(v)) if np.isfinite(v).any() else 0.0


# ---------------------------------------------------------------------------
# the JAX package (the tests and this script import both packages)
# ---------------------------------------------------------------------------

def perturb(tree, how: str):
    """The initial params moved by one f32 ulp (``jnp.nextafter``; traced
    under the reference's ``vmap(init_fn)``): every element up or down,
    every other element of each leaf (even flat positions) up, or the first
    layer of the first half (its ``w`` and ``b``) up."""
    import jax
    import jax.numpy as jnp

    def step(v, up=True):
        return jnp.nextafter(v, jnp.full_like(v, jnp.inf if up else -jnp.inf))

    if how in ("all_up", "all_down"):
        return jax.tree.map(lambda v: step(v, how == "all_up"), tree)
    if how == "alternate_up":
        def alt(v):
            even = (jnp.arange(v.size) % 2 == 0).reshape(v.shape)
            return jnp.where(even, step(v), v)
        return jax.tree.map(alt, tree)
    if how == "first_layer_up":
        first = {k: step(v) for k, v in tree[0][0].items()}
        return ([first] + list(tree[0][1:]),) + tuple(tree[1:])
    raise ValueError(how)


@contextlib.contextmanager
def perturbed_init(how):
    """``repro.core.engine.make_spec`` wrapped for the block so that the
    campaign's ``vmap(spec.init_fn)`` draws the same keys and returns them
    moved by ``perturb(..., how)``; nothing when ``how`` is None.  The
    reference's files are not touched."""
    from repro.core import engine as jengine
    if how is None:
        yield
        return
    make = jengine.make_spec

    def patched(*a, **k):
        spec = make(*a, **k)
        init = spec.init_fn
        return dataclasses.replace(
            spec, init_fn=lambda key: perturb(init(key), how))
    jengine.make_spec = patched
    try:
        yield
    finally:
        jengine.make_spec = make


def jax_run(fw, cd, test, seeds, eval_every=EVAL_EVERY, gamma=EVAL_GAMMA,
            ckpt_dir=None, how=None):
    from repro.configs.splitme_dnn import DNN10 as JDNN10
    from repro.core.cost import SystemParams as JSystemParams
    from repro.launch import campaign as jcampaign
    extra = ({} if ckpt_dir is None
             else dict(checkpoint_every=1, checkpoint_dir=ckpt_dir))
    with perturbed_init(how):
        return jcampaign.run_campaign(
            fw, JDNN10, JSystemParams(seed=0), cd, test_data=test,
            **campaign_kw(fw, seeds, eval_every, gamma), **extra)


def envelope(fw, cd, test) -> dict:
    """The reference's one-ulp envelope of ``fw`` over its horizon: per
    round (index r: after round r + 1) the largest |Δ params| (over seeds
    and leaves), |Δ loss| and |Δ accuracy| of each perturbed campaign from
    the unperturbed one, and their maximum over the perturbations."""
    runs = {}
    for how in (None,) + PERTURBATIONS:
        with tempfile.TemporaryDirectory() as d:
            t0 = time.time()
            res = jax_run(fw, cd, test, HORIZON_SEEDS, eval_every=1,
                          ckpt_dir=d, how=how)
            runs[how] = (checkpoint_params(d), np.asarray(res.losses),
                         np.asarray(res.accuracy_per_round))
            print(f"  {fw} {how}: {time.time() - t0:.1f} s, final accuracy "
                  f"{np.round(res.accuracy, 4).tolist()}", flush=True)
    R = rounds_of(fw)
    base_p, base_l, base_a = runs[None]
    out = {"rounds": R, "seeds": list(HORIZON_SEEDS), "perturbations": {}}
    for how in PERTURBATIONS:
        p, l, a = runs[how]
        out["perturbations"][how] = {
            "params": [max_param_diff(p[r + 1], base_p[r + 1])
                       for r in range(R)],
            "loss": [nan_max(np.abs(l[:, r] - base_l[:, r]))
                     for r in range(R)],
            "accuracy": [nan_max(np.abs(a[r] - base_a[r]))
                         for r in range(R)]}
    for key in ("params", "loss", "accuracy"):
        out[key] = [max(out["perturbations"][h][key][r]
                        for h in PERTURBATIONS) for r in range(R)]
    out["final_accuracy"] = base_a[R - 1].tolist()
    return out


# ---------------------------------------------------------------------------
# the replayed parity runs of tests/test_torch_horizon_*.py
# ---------------------------------------------------------------------------

METRICS = ("round", "n_selected", "E", "comm_bits", "sim_time", "cost",
           "energy")


def unflatten_params(flat: dict):
    """A checkpoint's ``params/<half>/<layer>/<leaf>`` arrays as the params
    tuple (halves of layer dicts)."""
    halves = {}
    for key, v in flat.items():
        _, i, l, k = key.split("/")
        halves.setdefault(int(i), {}).setdefault(int(l), {})[k] = v
    return tuple([halves[i][l] for l in sorted(halves[i])]
                 for i in sorted(halves))


def _side(res, ckpt_dir, accuracy) -> dict:
    return {"a": res.schedule.a, "b": res.schedule.b, "E": res.schedule.E,
            "metrics": [{f: getattr(m, f) for f in METRICS}
                        for m in res.metrics],
            "losses": np.asarray(res.losses),
            "params": checkpoint_params(ckpt_dir), "accuracy": accuracy}


def reference_replayed(fw, cd, test, ckpt_dir) -> dict:
    """The reference's side of the replayed parity run of ``fw`` (seeds
    ``HORIZON_SEEDS``), checkpointed every ``EVAL_EVERY`` rounds into
    ``ckpt_dir``: the params at each evaluation.  Its accuracy at each
    evaluation is its ``build_eval_fn`` (vmapped over the seeds, jitted
    once) on the checkpointed params, so that its round programs compile
    without the fused evaluation (the same function; about half the
    reference's compile time)."""
    import jax
    from repro.configs.splitme_dnn import DNN10 as JDNN10
    from repro.core import engine as jengine
    from repro.core.cost import SystemParams as JSystemParams
    from repro.launch import campaign as jcampaign
    R = rounds_of(fw)
    want = jcampaign.run_campaign(
        fw, JDNN10, JSystemParams(seed=0), cd, rounds=R,
        seeds=HORIZON_SEEDS, checkpoint_every=EVAL_EVERY,
        checkpoint_dir=ckpt_dir, **FRAMEWORKS[fw])
    spec = jengine.make_spec(fw, JDNN10, masked_loss_metric=True)
    eval_fn = jax.jit(jax.vmap(jengine.build_eval_fn(
        spec, JDNN10, *test, gamma=EVAL_GAMMA, jit=False,
        client_data=cd if fw == "splitme" else None)))
    params = checkpoint_params(ckpt_dir)
    acc = {r: np.asarray(eval_fn(unflatten_params(params[r])))
           for r in range(EVAL_EVERY, R + 1, EVAL_EVERY)}
    return _side(want, ckpt_dir, acc)


def port_replayed(fw, cd, test, ckpt_dir) -> dict:
    """The port's side: ``run_campaign`` from the reference's initial
    params on its key chains' batch indices (``CampaignIndexDraws``, one
    compiled call), checkpointed every ``EVAL_EVERY`` rounds, evaluating
    inside the campaign."""
    from repro.configs.splitme_dnn import DNN10 as JDNN10
    from repro_torch.configs.splitme_dnn import DNN10
    from repro_torch.core.cost import SystemParams
    from repro_torch.launch import campaign
    from torch_parity import CampaignIndexDraws, jax_initial_params
    R = rounds_of(fw)
    draws = CampaignIndexDraws(HORIZON_SEEDS, R, M, B, SAMPLES,
                               e_max=E_CAP, n_phases=n_phases(fw))
    got = campaign.run_campaign(
        fw, DNN10, SystemParams(seed=0), cd, device="cpu",
        params=jax_initial_params(fw, JDNN10, HORIZON_SEEDS),
        index_source=draws, test_data=test,
        checkpoint_every=EVAL_EVERY, checkpoint_dir=ckpt_dir,
        **campaign_kw(fw, HORIZON_SEEDS))
    acc = {r: np.asarray(got.accuracy_per_round[r - 1])
           for r in range(EVAL_EVERY, R + 1, EVAL_EVERY)}
    return _side(got, ckpt_dir, acc)


def start_reference(fws, out_dir) -> subprocess.Popen:
    """The reference's replayed runs of ``fws`` in a subprocess of their own
    (``replay-jax``), so that they run beside the port's; the results land
    in ``out_dir/<fw>.pkl``."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
           if p]))
    log = open(os.path.join(out_dir, "reference.log"), "w")
    return subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "replay-jax",
         str(out_dir)] + list(fws), env=env, stdout=log,
        stderr=subprocess.STDOUT)


def reference_result(proc, fw, out_dir, timeout=REPLAY_TIMEOUT) -> dict:
    """Wait for ``start_reference``'s run of ``fw`` and load it."""
    path = os.path.join(out_dir, f"{fw}.pkl")
    t0 = time.time()
    while not os.path.exists(path):
        if proc.poll() is not None and not os.path.exists(path):
            log = Path(out_dir, "reference.log").read_text()[-4000:]
            raise RuntimeError(f"the reference's run of {fw} ended "
                               f"(rc {proc.returncode}):\n{log}")
        if time.time() - t0 > timeout:
            proc.kill()
            raise TimeoutError(f"the reference's run of {fw}")
        time.sleep(0.2)
    with open(path, "rb") as f:
        return pickle.load(f)


def replay_reference_main(out_dir, fws) -> int:
    cd, test = campaign_data()
    for fw in fws:
        side = reference_replayed(fw, cd, test,
                                  os.path.join(out_dir, f"jax-{fw}"))
        tmp = os.path.join(out_dir, f"{fw}.pkl.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(side, f)
        os.replace(tmp, os.path.join(out_dir, f"{fw}.pkl"))
    return 0


def bound(env: float) -> float:
    """A difference's bound from the reference's envelope at that round:
    the JAX package's own 1e-5 where the envelope is at most 1e-5, else
    twice the envelope (the port's difference is one more draw from the
    same sensitivity)."""
    return F32_TOL if env <= F32_TOL else 2.0 * env


F32_TOL = 1e-5


def load_envelope(fw: str) -> dict:
    return json.loads(ENVELOPE_FILE.read_text())[fw]


def check_schedule(want, got) -> None:
    """The schedule and the system metrics exactly."""
    for k in ("a", "b", "E"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["metrics"] == want["metrics"]


def replayed_diffs(what, want, got) -> dict:
    """{round: the port's largest difference from the reference} of each
    round's losses (``loss``), or of the params or the accuracy at each
    evaluation."""
    if what == "loss":
        d = np.abs(got["losses"] - want["losses"]).max(axis=(0, 2))
        return {r + 1: float(v) for r, v in enumerate(d)}
    if what == "params":
        assert got["params"].keys() == want["params"].keys()
        return {r: max_param_diff(got["params"][r], want["params"][r])
                for r in sorted(want["params"])}
    assert got["accuracy"].keys() == want["accuracy"].keys()
    return {r: float(np.max(np.abs(got["accuracy"][r]
                                   - want["accuracy"][r])))
            for r in sorted(want["accuracy"])}


def check_curve(fw, what, want, got) -> float:
    """Hold ``replayed_diffs`` within ``bound`` of the reference's envelope
    at each round: the largest difference any one-ulp perturbation made in
    the reference by that round (the running maximum over rounds of the
    maximum over the perturbations and seeds; once a trajectory has parted,
    its difference at one round rises and falls with the round's batches,
    and the envelope is its upper hull).  Returns the largest share of its
    bound a round used (the measured margin)."""
    env = np.maximum.accumulate(load_envelope(fw)[what])
    diffs = replayed_diffs(what, want, got)
    want_rounds = (rounds_of(fw) if what == "loss"
                   else rounds_of(fw) // EVAL_EVERY)
    assert len(diffs) == want_rounds, (what, sorted(diffs))
    share = 0.0
    for r, v in diffs.items():
        lim = bound(env[r - 1])
        assert v <= lim, (f"{fw}: {what} after round {r} differ by {v:.3e} "
                          f"> {lim:.3e} (the reference's envelope by then "
                          f"{env[r - 1]:.3e})")
        share = max(share, v / lim)
    print(f"{fw} {what} (round: envelope / port): " + ", ".join(
        f"{r}: {env[r - 1]:.2e} / {v:.2e}" for r, v in diffs.items()
        if what != "loss" or r % EVAL_EVERY == 0 or r <= 3)
        + f"; largest share of the bound {share:.3g}")
    return share


# ---------------------------------------------------------------------------
# each package on its own draws
# ---------------------------------------------------------------------------

def port_run(fw, cd, test, seeds, gamma):
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.splitme_dnn import DNN10
    from repro_torch.core.cost import SystemParams
    from repro_torch.launch import campaign
    return campaign.run_campaign(
        fw, DNN10, SystemParams(seed=0), cd, test_data=test, device="cpu",
        **campaign_kw(fw, seeds, gamma=gamma))


def mann_whitney(a, b) -> float:
    from scipy.stats import mannwhitneyu
    return float(mannwhitneyu(a, b, alternative="two-sided").pvalue)


def fisher_low(a, b) -> float:
    """Two-sided Fisher exact p of the counts below ``LOW_ACC``."""
    from scipy.stats import fisher_exact
    lo_a, lo_b = (int((np.asarray(v) < LOW_ACC).sum()) for v in (a, b))
    return float(fisher_exact([[lo_a, len(a) - lo_a], [lo_b, len(b) - lo_b]],
                              alternative="two-sided").pvalue)


def summary(acc) -> dict:
    acc = np.asarray(acc, np.float64)
    return {"finals": [round(float(v), 6) for v in acc],
            "median": float(np.median(acc)), "min": float(acc.min()),
            "max": float(acc.max()), "mean": float(acc.mean()),
            "below": int((acc < LOW_ACC).sum())}


def seed_distributions(fws, n_seeds, cd, test) -> dict:
    """Each framework's finals over seeds 0 .. n_seeds-1 on each side, at
    the example's default SplitMe ridge (``run_campaign``'s 1e-3)."""
    seeds = tuple(range(n_seeds))
    out = {}
    for fw in fws:
        row = {}
        for which in ("jax", "port"):
            t0 = time.time()
            run = jax_run if which == "jax" else port_run
            res = run(fw, cd, test, seeds, gamma=1e-3)
            row[which] = summary(res.accuracy)
            row[which]["seconds"] = round(time.time() - t0, 1)
        row["mann_whitney_p"] = mann_whitney(row["jax"]["finals"],
                                             row["port"]["finals"])
        row["fisher_low_p"] = fisher_low(row["jax"]["finals"],
                                         row["port"]["finals"])
        out[fw] = row
        print(f"{fw}: " + " | ".join(
            f"{w} median {r['median']:.4f} min {r['min']:.4f} below "
            f"{LOW_ACC} {r['below']}/{n_seeds} ({r['seconds']} s)"
            for w, r in row.items() if isinstance(r, dict))
            + f" | p {row['mann_whitney_p']:.4g}, below {LOW_ACC}: Fisher "
            f"p {row['fisher_low_p']:.4g}", flush=True)
        for w, r in row.items():
            if isinstance(r, dict):
                print(f"  {w} finals {r['finals']}", flush=True)
    return out


def print_table(dists: dict) -> None:
    """The seed distributions as a markdown table (PERF.md's)."""
    print("| framework | JAX median | port median | JAX min | port min | "
          f"JAX < {LOW_ACC} | port < {LOW_ACC} | Mann-Whitney p | "
          "Fisher p |")
    print("|---|---|---|---|---|---|---|---|---|")
    for fw, d in dists.items():
        j, p = d["jax"], d["port"]
        n = len(j["finals"])
        fisher = d.get("fisher_low_p",
                       fisher_low(j["finals"], p["finals"]))
        print(f"| {fw} | {j['median']:.4f} | {p['median']:.4f} | "
              f"{j['min']:.4f} | {p['min']:.4f} | {j['below']}/{n} | "
              f"{p['below']}/{n} | {d['mann_whitney_p']:.4g} | "
              f"{fisher:.4g} |")


def write_reference(dists: dict, n_seeds: int) -> None:
    import jax
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                            capture_output=True, text=True).stdout.strip()
    REFERENCE_FILE.parent.mkdir(parents=True, exist_ok=True)
    REFERENCE_FILE.write_text(json.dumps({
        "what": "final test accuracy of each framework's JAX campaign "
                "(repro.launch.campaign.run_campaign), one per seed, at "
                "the example's setting; made by tests/torch_horizon_check.py "
                "seeds, then reference",
        "setting": {"n_per_class": N_PER_CLASS, "M": M,
                    "samples_per_client": SAMPLES, "batch": B,
                    "model": "DNN10", "system_params_seed": 0,
                    "rounds": {fw: rounds_of(fw) for fw in dists},
                    "hyper": {fw: FRAMEWORKS[fw] for fw in dists},
                    "eval_every": EVAL_EVERY, "splitme_eval_gamma": 1e-3,
                    "seeds": list(range(n_seeds))},
        "jax_version": jax.__version__, "commit": commit,
        "finals": {fw: d["jax"]["finals"] for fw, d in dists.items()},
    }, indent=1) + "\n")
    print(f"wrote {REFERENCE_FILE}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("envelope", "seeds", "reference",
                                     "merge", "replay-jax"))
    ap.add_argument("out")
    ap.add_argument("args", nargs="*",
                    help="frameworks (envelope, seeds: all six by default) "
                         "or the seeds runs' JSON files (reference)")
    ap.add_argument("--seeds", type=int, default=N_SEEDS)
    ap.add_argument("--threads", type=int, default=1,
                    help="torch intra-op threads of the port's runs")
    args = ap.parse_args(argv)
    if args.mode == "replay-jax":
        sys.path.insert(0, str(ROOT / "tests"))
        return replay_reference_main(args.out, args.args)
    if args.mode in ("reference", "merge"):
        merged = {}
        for path in args.args:
            part = json.loads(Path(path).read_text())
            merged.update({fw: v for fw, v in part.items()
                           if fw in FRAMEWORKS})
        merged = {fw: merged[fw] for fw in FRAMEWORKS if fw in merged}
        if args.mode == "merge":
            Path(args.out).write_text(json.dumps(merged, indent=1) + "\n")
            return 0
        print_table(merged)
        write_reference(merged, len(next(iter(merged.values()))["jax"]
                                    ["finals"]))
        Path(args.out).write_text(json.dumps(merged, indent=1) + "\n")
        return 0
    frameworks = args.args or list(FRAMEWORKS)
    for fw in frameworks:
        if fw not in FRAMEWORKS:
            ap.error(f"unknown framework {fw!r}")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tests"))
    import torch
    torch.set_num_threads(args.threads)
    cd, test = campaign_data()
    t0 = time.time()
    if args.mode == "envelope":
        result = {fw: envelope(fw, cd, test) for fw in frameworks}
    else:
        result = seed_distributions(frameworks, args.seeds, cd, test)
    result["seconds"] = round(time.time() - t0, 1)
    Path(args.out).write_text(json.dumps(result, indent=1) + "\n")
    print(f"wrote {args.out} ({result['seconds']} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

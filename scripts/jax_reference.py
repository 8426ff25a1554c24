#!/usr/bin/env python3
"""Evaluate the JAX reference on the CPU for the port's records.

Three commands, each run on the CPU only; this script imports JAX and the
JAX package and is never run on the card.

``draws``: the reference runner's simulated-user draws, to a file the port
reads.  ``ital_tpu.runner`` keys each session by
``fold_in(fold_in(fold_in(PRNGKey(seed), rep), cls), query)``; round ``r``
splits ``fold_in(skey, r)`` into a selection key and a user key, and
``ital_tpu.data.user.simulate_feedback`` splits the user key again into the
uniforms that decide skips (``u_label``) and mistakes (``u_flip``).  The
file (``.npz``) holds them for every session of a configuration at the
given seeds:

* ``sessions`` (S, 4) int64: ``seed, rep, cls, query`` of each session;
* ``u_label``, ``u_flip`` (S, n_rounds, batch_size) float32.

The port's study scripts feed it through
``ital_tpu_torch.runner.round_draws`` (``--user-draws``).  The uniforms do
not depend on the user's label and mistake probabilities, so one file
serves every noise level.  ``draws --task regression`` exports the
regression runner's draws instead (``ital_tpu.runner.
run_regression_experiment``: round ``r`` of repetition ``rep`` splits
``fold_in(fold_in(PRNGKey(seed), rep), r)`` into a selection key, the
label key and the noise key), for ``scripts/regression_learning_study.py``'s
task (``--rounds``, ``--batch-size``, one repetition):

* ``sessions`` (S, 2) int64: ``seed, rep``;
* ``u_label`` (S, n_rounds, batch_size) float32: the uniforms that decide
  which answers are labeled;
* ``eps`` (S, n_rounds, batch_size) float32: the N(0, 1) observation errors.

``scripts/regression_learning_study_torch.py`` feeds it through
``ital_tpu_torch.runner.regression_draws`` (``--user-draws``).

``partings``: where a port run's picks (``scripts/pool_refine_torch.py
--picks-out``) part from the reference's on the same user draws.  For each
seed it runs the reference's fused cohorts (the code of
``ital_tpu.runner.run_experiment_vmapped``, keeping each session's final
labeled rows) at ``scripts/pool_refine.py``'s configuration, prints its
final MAP beside the reference's CPU record, and at each session's first
parting step rebuilds the shared history in both packages (f32, and the
port in f64) and scores that greedy step: the MI of both picks in each
package and in f64, each package's tie set within 1e-6 of its maximum,
its exact ties, the f64 maximum.  Writes the rows as JSON.

``orders``: the reference's ``full 128`` at the given seeds with the
corpus's rows in other orders (``tie_order_study_torch.row_order``, order 0
the corpus's own), each session keeping its query row and its session key
(so its draws), as ``scripts/tie_order_study_torch.py`` runs the port.
With ``--port`` (a record of that script) it pairs, seed by seed, the
port's final MAP averaged over its orders with the reference's averaged
over these: a comparison that averages each side's tie-breaking out.

Run from the repository root::

    python3 scripts/jax_reference.py draws --seeds 0-7 \\
        --out results/jax_user_draws_mirflickr_s0-7_torch.npz
    python3 scripts/jax_reference.py draws --task regression --seeds 0-7 \\
        --out results/jax_user_draws_regression_toy_s0-7_torch.npz
    python3 scripts/jax_reference.py partings --picks results/pool_refine_picks_torch.json \\
        --seeds 0-7 --out results/full_scan_partings_torch.json
    python3 scripts/jax_reference.py orders --orders 0-3 --seeds 0-7 \\
        --port results/tie_order_torch.json --out results/tie_order_reference_torch.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

MIRFLICKR = os.path.join(REPO, "configs", "mirflickr.ini")
TIE = 1e-6


def _cpu_jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def export(config: str, seeds: list, overrides: tuple = ()) -> dict:
    """The arrays of a draws file for ``config`` (plus ``overrides``) at ``seeds``."""
    jax = _cpu_jax()
    from ital_tpu.data import datasets
    from ital_tpu.runner import _session_plan
    from ital_tpu.utils.config import load_config

    base = load_config(config, tuple(overrides))
    ds = datasets.load_dataset(base.dataset, **base.dataset_kwargs)
    sessions, u_label, u_flip = [], [], []
    for seed in seeds:
        cfg = load_config(config, tuple(overrides) + (f"EXPERIMENT.seed={seed}",))
        for rep, cls, query, skey in _session_plan(cfg, ds):
            lab, flip = [], []
            for rnd in range(cfg.n_rounds):
                _, k_user = jax.random.split(jax.random.fold_in(skey, rnd))
                k_label, k_flip = jax.random.split(k_user)
                lab.append(np.asarray(jax.random.uniform(k_label, (cfg.batch_size,))))
                flip.append(np.asarray(jax.random.uniform(k_flip, (cfg.batch_size,))))
            sessions.append((seed, rep, cls, query))
            u_label.append(lab)
            u_flip.append(flip)
    return {"sessions": np.asarray(sessions, np.int64),
            "u_label": np.asarray(u_label, np.float32),
            "u_flip": np.asarray(u_flip, np.float32)}


def export_regression(seeds: list, n_rounds: int, batch_size: int,
                      repetitions: int = 1) -> dict:
    """The arrays of a regression draws file: each round's label uniforms
    and N(0, 1) errors of ``ital_tpu.runner.run_regression_experiment`` at
    ``seeds``."""
    jax = _cpu_jax()

    sessions, u_label, eps = [], [], []
    for seed in seeds:
        for rep in range(repetitions):
            key = jax.random.fold_in(jax.random.PRNGKey(seed), rep)
            lab, err = [], []
            for rnd in range(n_rounds):
                _, k_lab, k_eps = jax.random.split(jax.random.fold_in(key, rnd), 3)
                lab.append(np.asarray(jax.random.uniform(k_lab, (batch_size,))))
                err.append(np.asarray(jax.random.normal(k_eps, (batch_size,))))
            sessions.append((seed, rep))
            u_label.append(lab)
            eps.append(err)
    return {"sessions": np.asarray(sessions, np.int64),
            "u_label": np.asarray(u_label, np.float32), "eps": np.asarray(eps, np.float32)}


def reference_run(cfg, ds, plan=None) -> dict:
    """``ital_tpu.runner.run_experiment_vmapped``'s fused cohorts (no
    learning), keeping each session's labeled rows: ``{"map", "ap",
    "picks" (S, n_rounds, batch), "sessions"}``.  ``plan``: the sessions
    ``(rep, cls, query, key)``, by default ``ital_tpu.runner._session_plan``'s."""
    jax = _cpu_jax()
    import jax.numpy as jnp

    from ital_tpu import runner
    from ital_tpu.models import gp as gp_mod
    from ital_tpu.select.base import StrategyParams

    runner.apply_matmul_precision(cfg)
    state0 = gp_mod.gp_init(jnp.asarray(ds.x), cfg.gp.length_scale, cfg.gp.var, cfg.gp.noise,
                            cfg.cap, corpus_dtype=cfg.gp.corpus_dtype or None)
    params = StrategyParams(
        label_prob=jnp.asarray(cfg.user.label_prob),
        mistake_prob=jnp.asarray(cfg.user.mistake_prob),
        tradeoff=jnp.asarray(float(cfg.method_kwargs.get("tradeoff", 0.5))),
    )
    state_axes = gp_mod.GPState(
        x=None, idx=0, y=0, valid=0, count=0, l=0, beta=0, v=0, mu=0, sig2=0,
        hyper=gp_mod.GPHyper(length_scale=None, var=None, noise=None), density=None, x2=None)
    set_query_v = jax.jit(jax.vmap(gp_mod.gp_set_query, in_axes=(None, 0), out_axes=state_axes))
    fused_v = jax.jit(jax.vmap(runner.make_fused_session_fn(cfg),
                               in_axes=(state_axes, 0, 0, 0, None), out_axes=(state_axes, 0)))
    plan = runner._session_plan(cfg, ds) if plan is None else plan
    qb, n, per = cfg.query_batch, ds.n, cfg.n_rounds * cfg.batch_size
    aps, picks = [], []
    for start in range(0, len(plan), qb):
        chunk = plan[start:start + qb]
        padded = chunk + [chunk[0]] * (qb - len(chunk))
        qs = jnp.asarray([q for _, _, q, _ in padded], jnp.int32)
        relevant = jnp.asarray(np.stack([ds.relevance[:, c] for _, c, _, _ in padded]))
        exclude = jnp.zeros((qb, n), bool).at[jnp.arange(qb), qs].set(True)
        skeys = jnp.stack([sk for *_, sk in padded])
        final, ap = fused_v(set_query_v(state0, qs), skeys, relevant, exclude, params)
        aps.append(np.asarray(ap)[:len(chunk)])
        picks.append(np.asarray(final.idx)[:len(chunk), 1:1 + per])
    ap = np.concatenate(aps)
    return {"map": ap.mean(axis=0), "ap": ap,
            "picks": np.concatenate(picks).reshape(len(plan), cfg.n_rounds, cfg.batch_size),
            "sessions": [(rep, c, q) for rep, c, q, _ in plan]}


def replay_step(cfg, ds, seed: int, session, history, batch, t: int, picks: tuple) -> dict:
    """Score greedy step ``t`` of round ``len(history)`` of ``session``
    (``(rep, cls, query)``) after the labeled ``history`` (the rounds'
    batches both packages picked), the partial batch ``batch[:t]``, in the
    reference (f32) and the port (f32 and f64), on the CPU; report the two
    ``picks`` (reference's, port's)."""
    jax = _cpu_jax()
    import jax.numpy as jnp
    import torch

    from ital_tpu.data.user import simulate_feedback
    from ital_tpu.models import gp as jgp
    from ital_tpu.select import ital as jital
    from ital_tpu.select.base import StrategyParams as JParams
    from ital_tpu_torch.models import gp as tgp
    from ital_tpu_torch.select import ital as tital
    from ital_tpu_torch.select.base import StrategyParams as TParams

    rep, cls, query = session
    lp, mp = cfg.user.label_prob, cfg.user.mistake_prob
    jp = JParams(label_prob=jnp.asarray(lp), mistake_prob=jnp.asarray(mp))
    skey = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(seed), rep), cls), query)
    relevant = jnp.asarray(ds.relevance[:, cls])
    gp = (cfg.gp.length_scale, cfg.gp.var, cfg.gp.noise, cfg.cap)
    js = jgp.gp_set_query(jgp.gp_init(jnp.asarray(ds.x), *gp), jnp.asarray(query))
    ts = {dt: tgp.gp_set_query(tgp.gp_init(torch.from_numpy(ds.x).to(dt), *gp), query)
          for dt in (torch.float32, torch.float64)}
    for rnd, shown in enumerate(history):
        _, k_user = jax.random.split(jax.random.fold_in(skey, rnd))
        y, valid = simulate_feedback(k_user, jnp.asarray(shown), relevant, jp.label_prob,
                                     jp.mistake_prob)
        js = jgp.gp_update(js, jnp.asarray(shown), y, valid)
        for dt in ts:
            ts[dt] = tgp.gp_update(ts[dt], torch.from_numpy(np.asarray(shown)).long(),
                                   torch.from_numpy(np.asarray(y)).to(dt),
                                   torch.from_numpy(np.asarray(valid)))
    mi = {"reference": np.array(jital.score_candidates_mi(js, jnp.asarray(batch), t, jp))}
    for dt, name in ((torch.float32, "port"), (torch.float64, "f64")):
        tp = TParams(**{k: torch.tensor(v, dtype=dt) for k, v in (
            ("label_prob", lp), ("mistake_prob", mp), ("jitter", 1e-6), ("tradeoff", 0.5))})
        mi[name] = tital.score_candidates_mi(ts[dt], torch.from_numpy(np.asarray(batch)).long(),
                                             t, tp).numpy().astype(np.float64)
    labeled = np.asarray(js.idx)[np.asarray(js.active)]
    for v in mi.values():
        v[labeled] = -np.inf
        v[np.asarray(batch[:t])] = -np.inf
    row = {"picks": list(picks)}
    for name, v in mi.items():
        top = v.max()
        row[name] = {"mi": [float(v[p]) for p in picks], "max": float(top),
                     "argmax": int(np.argmax(v)), "tie_set": int((v >= top - TIE).sum()),
                     "exact_ties": int((v == top).sum())}
    row["port"]["pick_is_lowest_of_its_exact_ties"] = bool(
        picks[1] == int(np.flatnonzero(mi["port"] == mi["port"][picks[1]])[0]))
    scored = np.isfinite(mi["reference"])
    row["max_abs_mi_diff"] = float(np.abs(mi["reference"][scored] - mi["port"][scored]).max())
    return row


def partings(picks_path: str, seeds: list, *, section: str = "map", tag: str = "full 128",
             log=print) -> dict:
    """The first parting of each session of the port's ``picks_path`` run
    from the reference's at ``seeds``, replayed (:func:`replay_step`)."""
    from ital_tpu.data import datasets
    from ital_tpu.utils.config import load_config
    from pool_refine_torch import MAP_CONFIGS, method_overrides

    with open(picks_path) as fh:
        port = json.load(fh)[section][tag]
    with open(os.path.join(REPO, "results", "pool_refine_map_cpu.json")) as fh:
        record = json.load(fh)[section][tag]
    (_, *conf), = [c for c in MAP_CONFIGS if c[0] == tag]
    heavy = ("USER.label_prob=0.6", "USER.mistake_prob=0.15") if section == "map_heavy" else ()
    ds = datasets.mirflickr()
    out = {"section": section, "tag": tag, "seeds": seeds, "tie": TIE, "reference_final": {},
           "record_final": {}, "rows": []}
    for seed in seeds:
        cfg = load_config(MIRFLICKR, (
            f"EXPERIMENT.seed={seed}", "EXPERIMENT.query_batch=7",
            "EXPERIMENT.fused_sessions=true",
            *(f"METHOD.{kv}" for kv in method_overrides(*conf)), *heavy))
        t0 = time.time()
        ref = reference_run(cfg, ds)
        final = round(float(ref["map"][-1]), 4)
        out["reference_final"][str(seed)] = final
        if seed in record["seeds"]:
            out["record_final"][str(seed)] = record["final_map_by_seed"][record["seeds"].index(seed)]
        log(f"seed {seed}: the reference's final MAP {final} (record "
            f"{out['record_final'].get(str(seed))}), {time.time() - t0:.1f} s")
        theirs = np.asarray(port[str(seed)])
        for k, session in enumerate(ref["sessions"]):
            differ = np.argwhere(ref["picks"][k] != theirs[k])
            row = {"seed": seed, "session": k, "rep_cls_query": list(session), "parting": None}
            if len(differ):
                rnd, t = (int(v) for v in differ[0])
                row["parting"] = [rnd, t]
                row.update(replay_step(cfg, ds, seed, session, ref["picks"][k][:rnd],
                                       ref["picks"][k][rnd], t,
                                       (int(ref["picks"][k][rnd, t]), int(theirs[k][rnd, t]))))
            out["rows"].append(row)
            log(json.dumps(row))
    return out


def orders(config: str, order_list: list, seeds: list, overrides: tuple = (), *,
           port_path: str | None = None, log=print) -> dict:
    """The reference's ``full 128`` run (:func:`reference_run`) at ``seeds``
    with the rows of ``config``'s corpus in each order of ``order_list``; each
    session keeps its query row and its key.  With ``port_path``, the port's
    and the reference's finals averaged over their orders, paired by seed."""
    from compare_records_torch import interval
    from pool_refine_torch import MAP_CONFIGS, method_overrides
    from tie_order_study_torch import permuted, row_order

    from ital_tpu.data import datasets
    from ital_tpu.runner import _session_plan
    from ital_tpu.utils.config import load_config

    _cpu_jax()
    tag, *conf = MAP_CONFIGS[0]
    base = load_config(config, tuple(overrides))
    ds = datasets.load_dataset(base.dataset, **base.dataset_kwargs)
    out = {"tag": tag, "seeds": seeds, "n": ds.n, "platform": "cpu", "orders": {}}
    for order in order_list:
        perm = row_order(ds.n, order)
        inv = np.argsort(perm)
        moved = permuted(ds, perm)
        entry = out["orders"][str(order)] = {"final_map_by_seed": [], "map_by_seed": {}}
        for seed in seeds:
            cfg = load_config(config, tuple(overrides) + (
                f"EXPERIMENT.seed={seed}", "EXPERIMENT.query_batch=7",
                "EXPERIMENT.fused_sessions=true",
                *(f"METHOD.{kv}" for kv in method_overrides(*conf))))
            plan = [(rep, c, int(inv[q]), key) for rep, c, q, key in _session_plan(cfg, ds)]
            t0 = time.time()
            res = reference_run(cfg, moved, plan)
            curve = [round(float(v), 4) for v in res["map"]]
            entry["map_by_seed"][str(seed)] = curve
            entry["final_map_by_seed"].append(curve[-1])
            log(f"order {order} seed {seed}: final {curve[-1]} ({time.time() - t0:.1f} s)")
        log(f"order {order}: final {np.mean(entry['final_map_by_seed']):.4f}")
    ref_mean = {s: float(np.mean([o["final_map_by_seed"][i] for o in out["orders"].values()]))
                for i, s in enumerate(seeds)}
    out["final_map_by_seed"] = [ref_mean[s] for s in seeds]
    if port_path:
        with open(port_path) as fh:
            port = json.load(fh)
        port_seeds = next(iter(port["orders"].values()))["seeds"]
        port_mean = dict(zip(port_seeds, port["over_orders"]["final_map_by_seed"]))
        delta = interval([port_mean[s] - ref_mean[s] for s in seeds])
        out["port_over_orders"] = dict(
            delta, record=os.path.basename(port_path), port_orders=list(port["orders"]),
            held=None if delta["lo"] is None else bool(delta["lo"] <= 0.0 <= delta["hi"]))
        log(f"the port over its orders - the reference over these: {json.dumps(delta)}")
    return out


def main(argv=None) -> int:
    from study_torch import parse_seeds, record_path

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="command", required=True)
    d = sub.add_parser("draws", help="export the reference's user draws (.npz)")
    d.add_argument("--task", default="retrieval", choices=("retrieval", "regression"))
    d.add_argument("--config", default=MIRFLICKR, help="the retrieval task's config")
    d.add_argument("--rounds", type=int, default=10, help="the regression task's rounds")
    d.add_argument("--batch-size", type=int, default=4, help="the regression task's batch")
    d.add_argument("--seeds", default="0-7", help="seeds as 0,1,2 or 0-7")
    d.add_argument("--out", required=True, help="the .npz to write (its name carries _torch)")
    d.add_argument("overrides", nargs="*", help="SECTION.key=value config overrides")
    p = sub.add_parser("partings", help="replay where a port run parts from the reference")
    p.add_argument("--picks", required=True, help="pool_refine_torch.py --picks-out's file")
    p.add_argument("--section", default="map", choices=("map", "map_heavy"))
    p.add_argument("--tag", default="full 128")
    p.add_argument("--seeds", default="0-7", help="seeds as 0,1,2 or 0-7")
    p.add_argument("--out", required=True, help="the JSON to write (its name carries _torch)")
    o = sub.add_parser("orders", help="the reference's full 128 with the corpus's rows reordered")
    o.add_argument("--config", default=MIRFLICKR)
    o.add_argument("--orders", default="0-3", help="row orders as 0,1,2 or 0-3")
    o.add_argument("--seeds", default="0-7", help="seeds as 0,1,2 or 0-7")
    o.add_argument("--port", default=None,
                   help="a record of tie_order_study_torch.py to pair with, seed by seed")
    o.add_argument("--out", required=True, help="the JSON to write (its name carries _torch)")
    o.add_argument("overrides", nargs="*", help="SECTION.key=value config overrides")
    args = ap.parse_args(argv)
    record_path(args.out)
    if args.command == "draws":
        arrays = (export(args.config, parse_seeds(args.seeds), tuple(args.overrides))
                  if args.task == "retrieval" else
                  export_regression(parse_seeds(args.seeds), args.rounds, args.batch_size))
        np.savez(args.out, **arrays)
        print(f"wrote {args.out}: {len(arrays['sessions'])} sessions x "
              f"{arrays['u_label'].shape[1]} rounds x {arrays['u_label'].shape[2]}", flush=True)
        return 0
    log = lambda s: print(s, flush=True)  # noqa: E731
    if args.command == "orders":
        rows = orders(args.config, parse_seeds(args.orders), parse_seeds(args.seeds),
                      tuple(args.overrides), port_path=args.port, log=log)
    else:
        rows = partings(args.picks, parse_seeds(args.seeds), section=args.section,
                        tag=args.tag, log=log)
    with open(args.out, "w") as fh:
        json.dump(rows, fh, indent=1)
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

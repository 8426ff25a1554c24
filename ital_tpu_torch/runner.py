"""Experiment harness: simulated-feedback retrieval experiments, MAP-vs-rounds
(port of ``ital_tpu.runner``).

For each repetition x class x query: reset the GP to the query, then loop
``select -> simulated user -> update -> AP`` for ``n_rounds``, and average
the AP curves into a MAP-vs-rounds curve with per-round timing.  Everything
runs on one explicit device (or, with ``mesh_devices``, a mesh of them); on
a CUDA device every RBF block goes through the hand-written kernel.

Random draws are a function of (seed, repetition, class, query, round)
alone (:func:`round_draws`), never carried from round to round, so a session
resumed from its checkpoint is bit-identical to an uninterrupted one.  Tests
replace that function with one that hands over JAX's draws.

``GP.learn_every`` re-learns the hyperparameters from the session's labels
(:mod:`ital_tpu_torch.models.hyperopt`) every k rounds.

``EXPERIMENT.query_batch = K`` runs the sessions in cohorts of K: one
stacked selection and one stacked GP update advance the whole cohort each
round, as one program that stacks the sessions' states inside (on the card
a captured CUDA graph, the reference's ``round_v``).
``EXPERIMENT.fused_sessions`` runs each session's (or, with ``query_batch``, each cohort's) rounds as one
program (the reference's ``fused_v``), the re-learns of ``GP.learn_every``
included, and reads its AP curve and picks once at the end (see
:func:`_run_stacked`).  Both draw as the serial path draws, so the curves
are the serial path's.

``EXPERIMENT.mesh_devices = p`` shards the corpus over a mesh of p ranks
(:mod:`ital_tpu_torch.parallel`), one per card (clamped to the cards there
are) or, on the CPU, one per process, and runs each round as the sharded
round; every rank draws the serial path's draws, so the curves are its
curves.  With ``query_batch > 1`` or ``fused_sessions`` the mesh runs each
session or cohort fused (``parallel.sharded.make_sharded_session`` /
``make_sharded_cohort``).  The per-round mesh with ``cap >=
GP.chol2d_threshold`` absorbs labels by the distributed refit
(``parallel.bigcap.make_bigcap_round``: ``l`` in block-rows over the ranks)
when cap divides the mesh, and keeps the replicated factor with a warning
when it does not; fused and cohort meshes keep it with a warning.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ital_tpu_torch import graphs
from ital_tpu_torch.data import datasets as ds_mod
from ital_tpu_torch.data.user import feedback_from_uniforms
from ital_tpu_torch.models import gp as gp_mod
from ital_tpu_torch.models.hyperopt import LearnConfig, fit_hyperparams, relearn, relearn_stacked
from ital_tpu_torch.ops.chol import host_copy
from ital_tpu_torch.select.base import (
    StrategyParams,
    cohort_program,
    get_strategy,
    validate_method_kwargs,
)
from ital_tpu_torch.utils import checkpoint as ckpt
from ital_tpu_torch.utils.config import ExperimentConfig, apply_matmul_precision
from ital_tpu_torch.utils.logging import JsonlLogger, Timer, device_mem_mb
from ital_tpu_torch.utils.metrics import average_precision, recall_at_k

# Strategies that read the corpus density (computed once per dataset).
DENSITY_STRATEGIES = {"sud", "tcal", "adapt_al"}

# Recall@k cutoffs logged beside AP each round.
RECALL_KS = (10, 50)

def _steady_ms(val, div: int = 1):
    """round(val / div, 3), passing through None (no steady span recorded)."""
    return None if val is None else round(val / max(div, 1), 3)


def _check_capacity(cfg: ExperimentConfig, *, query_slots: int = 1) -> None:
    """Fail fast when the labeled buffers cannot hold the whole experiment
    (``query_slots=0`` for the regression task, which has no query image)."""
    needed = query_slots + cfg.n_rounds * cfg.batch_size
    if needed > cfg.cap:
        raise ValueError(
            f"labeled-slot capacity too small: {query_slots} query slot(s) + "
            f"{cfg.n_rounds} rounds x batch {cfg.batch_size} needs {needed} "
            f"slots but GP.cap={cfg.cap}; set [GP] cap >= {needed} "
            f"(or cap = 0 for auto-sizing)"
        )


def _seed(*keys: int) -> int:
    """A 63-bit generator seed that depends on ``keys`` and nothing else."""
    return int(np.random.SeedSequence(list(keys)).generate_state(1, np.uint64)[0] >> 1)


def round_draws(seed: int, rep: int, cls: int, query: int, rnd: int, batch_size: int,
                device) -> tuple[torch.Generator, torch.Tensor, torch.Tensor]:
    """Round ``rnd``'s random draws: ``(generator, u_label, u_flip)``.

    ``generator`` (on ``device``) feeds the strategy's own draws; ``u_label``
    and ``u_flip`` ((batch_size,) on ``device``) decide the simulated user's
    skips and mistakes.  The user's uniforms come from a CPU generator, so a
    run on the card and one on the CPU see the same user.
    """
    user = torch.Generator().manual_seed(_seed(seed, rep, cls, query, rnd, 1))
    u = host_copy(torch.rand(2, batch_size, generator=user), device)
    sel = torch.Generator(device=device).manual_seed(_seed(seed, rep, cls, query, rnd, 0))
    return sel, u[0], u[1]


def regression_draws(seed: int, rep: int, rnd: int, batch_size: int,
                     device) -> tuple[torch.Generator, torch.Tensor, torch.Tensor]:
    """A regression round's draws: ``(generator, u_label, eps)``, with ``eps``
    the (batch_size,) standard normals of the observation noise."""
    user = torch.Generator().manual_seed(_seed(seed, rep, rnd, 1))
    u_label = torch.rand(batch_size, generator=user).to(device)
    eps = torch.randn(batch_size, generator=user).to(device)
    sel = torch.Generator(device=device).manual_seed(_seed(seed, rep, rnd, 0))
    return sel, u_label, eps


def _session_plan(cfg: ExperimentConfig, dataset: ds_mod.Dataset) -> list[tuple[int, int, int]]:
    """The (rep, class, query) list, queries drawn as the reference draws them."""
    classes = dataset.classes
    if cfg.max_classes:
        classes = classes[: cfg.max_classes]
    rng = np.random.default_rng(cfg.seed)
    return [(rep, int(c), int(q))
            for rep in range(cfg.repetitions)
            for c in classes
            for q in dataset.queries_for_class(int(c), rng, cfg.queries_per_class)]


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


@contextlib.contextmanager
def _profiled(profile_dir: Optional[str], dev: torch.device):
    """Trace the block with ``torch.profiler`` into ``<profile_dir>/trace.json``."""
    if not profile_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def run_experiment(
    cfg: ExperimentConfig, dataset: Optional[ds_mod.Dataset] = None, *, device
) -> Dict[str, Any]:
    """Run the experiment on ``device``; returns curves and timing, logs JSONL per round.

    The result holds ``ap`` (n_sessions, n_rounds), the ``map`` curve, mean
    ``select_ms``/``update_ms``, their steady medians (first round excluded),
    ``first_round_ms``, the session list and the device's name; the cohort
    and fused modes the reference's keys for them (:func:`_run_stacked`).
    """
    dev = torch.device(device)
    if dataset is None:
        dataset = ds_mod.load_dataset(cfg.dataset, **cfg.dataset_kwargs)
    _check_capacity(cfg)
    if cfg.mesh_devices:
        return _run_sharded(cfg, dataset, dev)
    apply_matmul_precision(cfg)

    x = torch.from_numpy(dataset.x).to(dev)
    state0 = gp_mod.gp_init(x, cfg.gp.length_scale, cfg.gp.var, cfg.gp.noise, cfg.cap,
                            corpus_dtype=cfg.gp.corpus_dtype or None)
    if cfg.method in DENSITY_STRATEGIES:
        state0.density = gp_mod.corpus_density(state0)

    # "tradeoff" rides in StrategyParams; the rest of method_kwargs are the
    # strategy's keyword options (n_qmc, pool_size, ...).
    params = StrategyParams.create(
        dev, label_prob=cfg.user.label_prob, mistake_prob=cfg.user.mistake_prob,
        tradeoff=float(cfg.method_kwargs.get("tradeoff", 0.5)),
    )
    select_kwargs = {k: v for k, v in cfg.method_kwargs.items() if k != "tradeoff"}
    plan = _session_plan(cfg, dataset)
    if (cfg.query_batch or 0) > 1:
        return _run_stacked(cfg, dataset, state0, params, select_kwargs, plan)
    if cfg.fused_sessions:
        if cfg.checkpoint_dir or cfg.resume or cfg.profile_dir:
            print("# fused_sessions runs each session as one device program; "
                  "checkpoint_dir/resume/profile_dir are serial-mode features "
                  "and are ignored here")
        return _run_stacked(cfg, dataset, state0, params, select_kwargs, plan)
    ops = _serial_ops(cfg, dataset, params, select_kwargs, dev)
    return _run_sessions(cfg, dataset, state0, ops, plan, dev, profile_dir=cfg.profile_dir,
                         log_jsonl=cfg.log_jsonl)


@dataclasses.dataclass
class _SessionOps:
    """What a session's rounds run: the single-device functions
    (:func:`_serial_ops`) or their forms on a mesh (:func:`_sharded_run`).

    ``masks(c, q) -> (relevant, sel_forbid, exclude)``;
    ``step(state, draws, masks, timer) -> (state, ap, recalls)``, one
    round timed in the "select" and "update" spans; ``set_query(state, q)
    -> state`` resets a session's copy to its query;
    ``save``/``load`` write and read a round checkpoint; ``log`` holds extra
    JSONL fields.  ``layout`` lays a session out for ``step`` after
    ``gp_set_query`` and after a load, ``refit`` refits its posterior for
    ``GP.refit_every``, which ``drift_refit = False`` skips (a path that
    refits every round); ``relearn(state, cfg) -> state`` re-learns its
    hyperparameters and refits it (:func:`_relearn_hyperparams` on one
    device, :func:`_relearn_on_mesh` on a mesh).
    """

    masks: Callable
    step: Callable
    set_query: Callable
    save: Callable
    load: Callable
    log: Dict[str, Any]
    refit: Callable
    relearn: Callable
    layout: Callable = lambda state: state
    drift_refit: bool = True


def _absorb_body(x, *, batch, u_label, u_flip, relevant, exclude, **inputs) -> tuple:
    params = StrategyParams.from_inputs(inputs)
    y, valid = feedback_from_uniforms(u_label, u_flip, batch, relevant, params.label_prob,
                                      params.mistake_prob)
    state = gp_mod.gp_update(gp_mod.program_state(x, inputs), batch, y, valid)
    n = state.x.shape[0]
    return (average_precision(state.mu, relevant, exclude),
            *(recall_at_k(state.mu, relevant, min(k, n), exclude) for k in RECALL_KS))


def absorb_step(state, batch, u_label, u_flip, relevant, exclude, params):
    """The simulated user's answers to ``batch`` from the uniforms, the GP
    update of ``state`` (in place), then AP and recall@k of the new ranking,
    as one program (the reference's ``make_step_fns`` ``absorb_step``; on the
    card a captured graph, :func:`ital_tpu_torch.graphs.run`).  Returns
    ``(state, ap, recalls)``."""
    gp_mod.check_capacity([state.count], batch.shape[0], state.cap)
    inputs = {**gp_mod.program_inputs(state), **params.program_inputs(), "batch": batch,
              "u_label": u_label, "u_flip": u_flip, "relevant": relevant, "exclude": exclude}
    ap, *recalls = graphs.run("absorb_step", _absorb_body, inputs, shared={"x": state.x},
                              writes=gp_mod.SESSION_FIELDS)
    state.count += batch.shape[0]
    return state, ap, recalls


def _serial_ops(cfg, dataset, params, select_kwargs, dev) -> _SessionOps:
    select = get_strategy(cfg.method)
    n = dataset.n

    def masks(c, q):
        relevant = torch.from_numpy(np.ascontiguousarray(dataset.relevance[:, c])).to(dev)
        exclude = torch.zeros(n, dtype=torch.bool, device=dev)
        exclude[q] = True
        return relevant, None, exclude

    def step(state, draws, session_masks, timer):
        generator, u_label, u_flip = draws
        relevant, _, exclude = session_masks
        with timer.span("select"):
            batch = select(state, cfg.batch_size, generator, params, **select_kwargs)
        with timer.span("update"):
            state, ap, recalls = absorb_step(state, batch, u_label, u_flip, relevant, exclude,
                                             params)
        return state, ap, recalls

    return _SessionOps(masks=masks, step=step, set_query=gp_mod.gp_set_query,
                       save=ckpt.save_session,
                       load=ckpt.load_session, log={}, refit=gp_mod.gp_fit,
                       relearn=_relearn_hyperparams)


def _run_sessions(cfg, dataset, state0, ops, plan, dev, *, profile_dir, log_jsonl):
    """Every session of ``plan`` through ``ops``; the result dict."""
    logger = JsonlLogger(log_jsonl)
    timer = Timer(dev)
    ap_curves = []
    try:
        with _profiled(profile_dir, dev):
            for rep, c, q in plan:
                ap_curves.append(_run_session(cfg, state0, ops, rep, c, q, timer, logger))
    finally:
        logger.close()

    ap = np.asarray(ap_curves)
    return {
        "ap": ap,
        "map": ap.mean(axis=0) if ap.size else np.zeros(cfg.n_rounds),
        "select_ms": timer.ms("select"),
        "update_ms": timer.ms("update"),
        "select_ms_steady": _steady_ms(timer.median_ms("select")),
        "update_ms_steady": _steady_ms(timer.median_ms("update")),
        "first_round_ms": round(timer.first_ms("select") + timer.first_ms("update"), 3),
        "sessions": [{"rep": rep, "cls": c, "query": q} for rep, c, q in plan],
        "dataset": dataset.name,
        "method": cfg.method,
        "device": _device_name(dev),
    }


def _run_session(cfg, state0, ops, rep, c, q, timer, logger) -> list[float]:
    """One query session of ``n_rounds`` rounds, with checkpoint/resume.

    With ``cfg.checkpoint_dir`` every round snapshots the session;
    ``cfg.resume`` continues an interrupted session from its last completed
    round.  ``state0`` is the shared template: the session takes its own
    buffers before writing any.
    """
    dev = state0.mu.device
    masks = ops.masks(c, q)
    state = ops.set_query(gp_mod.gp_session_copy(state0), q)
    curve: list[float] = []
    start_round = 0
    ckpt_path = None
    if cfg.checkpoint_dir:
        ckpt_path = os.path.join(cfg.checkpoint_dir, f"r{rep}_c{c}_q{q}.npz")
        if cfg.resume and os.path.exists(ckpt_path):
            state, extras = ops.load(ckpt_path, state)
            curve = [float(v) for v in extras["curve"]]
            start_round = int(extras["next_round"])
    state = ops.layout(state)

    for rnd in range(start_round, cfg.n_rounds):
        draws = round_draws(cfg.seed, rep, c, q, rnd, cfg.batch_size, dev)
        state, ap, recalls = ops.step(state, draws, masks, timer)
        if cfg.gp.learn_every and (rnd + 1) % cfg.gp.learn_every == 0:
            state = ops.relearn(state, cfg)
        elif (cfg.gp.refit_every and ops.drift_refit
              and (rnd + 1) % cfg.gp.refit_every == 0):
            # Periodic from-scratch refit: bounds long-horizon f32 append drift.
            state = ops.refit(state)
        curve.append(float(ap))
        logger.log(
            rep=rep, cls=c, query=q, round=rnd, ap=curve[-1],
            select_ms=timer.last_ms("select"), update_ms=timer.last_ms("update"),
            labeled=int(state.active.sum()),
            device_mem_mb=round(device_mem_mb(dev), 1),
            **{f"recall@{k}": float(r) for k, r in zip(RECALL_KS, recalls)},
            **_hyper_log_fields(state, cfg), **ops.log,
        )
        if ckpt_path:
            ops.save(ckpt_path, state, extra={"curve": np.asarray(curve), "next_round": rnd + 1})
        _maybe_inject_fault(rnd)
    return curve


def _runs_fused(cfg) -> bool:
    return int(cfg.query_batch or 0) > 1 or bool(cfg.fused_sessions)


def _crossed(cfg) -> bool:
    """The capacity reached ``GP.chol2d_threshold`` (0 turns it off)."""
    return bool(cfg.gp.chol2d_threshold and cfg.cap >= cfg.gp.chol2d_threshold)


def _bigcap(cfg, n_dev: int) -> bool:
    """The per-round mesh of ``n_dev`` ranks takes the distributed refit."""
    return _crossed(cfg) and not _runs_fused(cfg) and cfg.cap % n_dev == 0


def _run_sharded(cfg, dataset, dev) -> Dict[str, Any]:
    """The sharded path (``EXPERIMENT.mesh_devices``): a mesh of
    ``mesh_devices`` ranks (on the card, clamped to the cards there are, as
    the reference clamps to its devices) each runs :func:`_sharded_run` over
    its corpus shard; returns rank 0's result.  With ``query_batch > 1`` or
    ``fused_sessions`` the sessions run fused (a mesh cohort always does, as
    the reference's), keeping the replicated factor past
    ``GP.chol2d_threshold`` with the reference's warning; the per-round path
    past it takes the distributed refit where cap divides the mesh, and the
    replicated factor with a warning where it does not."""
    from ital_tpu_torch.parallel.launch import launch
    from ital_tpu_torch.parallel.mesh import device_count

    qb = int(cfg.query_batch or 0)
    fused = _runs_fused(cfg)
    if _crossed(cfg) and fused:
        per_chip_mb = cfg.cap * cfg.cap * 4 / 1e6 * max(qb, 1)
        print(f"# WARNING: cap={cfg.cap} crossed chol2d_threshold={cfg.gp.chol2d_threshold} "
              f"but fused/cohort sessions cannot use the distributed chol2d refit (the "
              f"factor must stay replicated inside the fused program): ~{per_chip_mb:.0f} MB "
              f"of Cholesky factor per chip"
              + (f" ({qb} cohort sessions x cap^2)" if qb > 1 else "")
              + ". Unset fused_sessions/query_batch to enable the distributed refit "
              "(parallel/bigcap.py), or raise GP.chol2d_threshold to silence this.")
    if fused and cfg.gp.refit_every:
        print(_REFIT_IGNORED)
    if qb > 1 and not cfg.fused_sessions:
        print("# sharded cohorts run fused (all rounds in one device program); per-round "
              "JSONL granularity is traded away")
    if fused and (cfg.checkpoint_dir or cfg.resume or cfg.profile_dir):
        print("# fused_sessions runs each session as one device program; "
              "checkpoint_dir/resume/profile_dir are serial-mode features "
              "and are ignored here")
    available = device_count(dev.type)
    n_dev = cfg.mesh_devices
    if available is not None and available < n_dev:
        n_dev = max(available, 1)
        print(f"# mesh_devices={cfg.mesh_devices} requested, {available} available "
              f"-> using {n_dev}")
    if _crossed(cfg) and not fused:
        if _bigcap(cfg, n_dev):
            print(f"# cap={cfg.cap} >= chol2d_threshold={cfg.gp.chol2d_threshold}: "
                  f"distributed chol2d refit path (l row-sharded over {n_dev} devices)")
        else:
            print(f"# WARNING: cap={cfg.cap} crossed chol2d_threshold="
                  f"{cfg.gp.chol2d_threshold} but does not divide the {n_dev}-device mesh; "
                  f"using the REPLICATED factor path (~{cfg.cap * cfg.cap * 4 / 1e6:.0f} MB "
                  f"per chip). Round GP.cap up to a multiple of {n_dev} to enable the "
                  f"distributed refit.")
    return launch(n_dev, _sharded_run, cfg, dataset, device=dev)


def _sharded_run(mesh, cfg, dataset) -> Dict[str, Any]:
    """One rank of the sharded experiment: the corpus padded to the mesh,
    this rank's shard of ``gp_init`` (its density by a ring pass), then
    every session of the plan through the sharded round (past
    ``GP.chol2d_threshold`` the large-cap round, ``l`` in block-rows), or
    fused (:func:`_sharded_fused_run`).  The JSONL and the profile are rank
    0's."""
    from ital_tpu_torch.parallel import bigcap
    from ital_tpu_torch.parallel import sharded as sh

    dev = mesh.device
    apply_matmul_precision(cfg)
    x_pad, n_real = sh.pad_to_devices(dataset.x, mesh.size)
    n_pad = x_pad.shape[0]
    shard_n = n_pad // mesh.size
    lo = mesh.rank * shard_n
    x = torch.from_numpy(np.ascontiguousarray(x_pad[lo:lo + shard_n])).to(dev)
    state0 = gp_mod.gp_init(x, cfg.gp.length_scale, cfg.gp.var, cfg.gp.noise, cfg.cap,
                            corpus_dtype=cfg.gp.corpus_dtype or None)
    pad = torch.arange(n_pad, device=dev) >= n_real
    if cfg.method in DENSITY_STRATEGIES:
        state0.density = sh.make_sharded_density(mesh)(state0, pad)
    params = StrategyParams.create(
        dev, label_prob=cfg.user.label_prob, mistake_prob=cfg.user.mistake_prob,
        tradeoff=float(cfg.method_kwargs.get("tradeoff", 0.5)),
    )
    select_kwargs = {k: v for k, v in cfg.method_kwargs.items() if k != "tradeoff"}
    validate_method_kwargs(cfg.method, select_kwargs)
    # The mesh's options are ITAL's; the ring strategies take fixed blocks.
    options = select_kwargs if cfg.method == "ital" else {}
    relevance = np.zeros((n_pad, dataset.relevance.shape[1]), bool)
    relevance[:n_real] = dataset.relevance
    rank0 = mesh.rank == 0
    plan = _session_plan(cfg, dataset)
    if _runs_fused(cfg):
        run = dataclasses.replace(cfg, log_jsonl=cfg.log_jsonl if rank0 else None)
        res = _sharded_fused_run(mesh, run, dataset, plan, state0, params, options, relevance, pad)
        res["mesh_devices"] = mesh.size
        return res
    big = _bigcap(cfg, mesh.size)
    make_round = bigcap.make_bigcap_round if big else sh.make_sharded_round
    round_fn = make_round(mesh, strategy=cfg.method, batch_size=cfg.batch_size,
                          recall_ks=RECALL_KS, **options)
    refit = sh.make_sharded_fit(mesh)

    def masks(c, q):
        relevant = torch.from_numpy(np.ascontiguousarray(relevance[:, c])).to(dev)
        return (relevant, *sh.make_masks(n_pad, n_real, q, dev))

    def step(state, draws, session_masks, timer):
        state, _, ap, recalls = round_fn(state, *draws, *session_masks, params, timer=timer,
                                         n_real=n_real)
        return state, ap, recalls

    # Every session keeps state0's corpus shard: the labeled rows come from it.
    ops = _SessionOps(
        masks=masks, step=step, set_query=sh.make_sharded_set_query(mesh),
        save=lambda path, state, extra: sh.save_sharded_session(mesh, path, state, extra),
        load=lambda path, state: sh.load_sharded_session(mesh, path, state),
        log={"sharded": mesh.size},
        refit=refit,
        relearn=lambda state, cfg: sh.make_sharded_relearn(
            mesh, LearnConfig.from_gp(cfg.gp))(state),
    )
    if big:
        # set_query and a load leave l replicated: take this rank's block-row,
        # row-major as the programs captured it.  The refit is the
        # distributed one (a program), and a round already refits.
        refit = bigcap.make_bigcap_fit(mesh)
        ops = dataclasses.replace(
            ops, layout=lambda state: bigcap.shard_state_bigcap(state, mesh, corpus_sharded=True),
            refit=refit, drift_refit=False,
            relearn=functools.partial(_relearn_on_mesh, rows=functools.partial(
                sh.labeled_rows, mesh), refit=refit))
    res = _run_sessions(cfg, dataset, state0, ops, plan, dev,
                        profile_dir=cfg.profile_dir if rank0 else None,
                        log_jsonl=cfg.log_jsonl if rank0 else None)
    res["mesh_devices"] = mesh.size
    if big:
        res["chol2d"] = True
    return res


def _sharded_fused_run(mesh, cfg, dataset, plan, state0, params, options, relevance,
                       pad) -> Dict[str, Any]:
    """The fused modes on the mesh: each session
    (:func:`~ital_tpu_torch.parallel.sharded.make_sharded_session`) or each
    cohort of ``query_batch`` (:func:`~ital_tpu_torch.parallel.sharded.
    make_sharded_cohort`) runs all its rounds with no host read between
    them, from the draws :func:`round_draws` gives the single-device run, so
    the curves are that run's.  Rows carry ``sharded``; a cohort's result
    also ``fused``, as the reference's; the result carries ``picks``."""
    from ital_tpu_torch.parallel import sharded as sh

    dev = mesh.device
    size = max(cfg.query_batch or 0, 1)
    learn = LearnConfig.from_gp(cfg.gp) if cfg.gp.learn_every else None
    kw = dict(strategy=cfg.method, batch_size=cfg.batch_size, n_rounds=cfg.n_rounds,
              learn=learn, **options)
    program = sh.make_sharded_cohort(mesh, **kw) if size > 1 else sh.make_sharded_session(mesh, **kw)
    set_query = sh.make_sharded_set_query(mesh)

    def run_chunk(chunk):
        k = len(chunk)
        relevant = torch.from_numpy(np.stack([relevance[:, c] for _, c, _ in chunk])).to(dev)
        exclude = pad.repeat(k, 1)
        exclude[torch.arange(k, device=dev), torch.tensor([q for *_, q in chunk], device=dev)] = True
        states = [set_query(gp_mod.gp_session_copy(state0), q) for *_, q in chunk]
        if size == 1:
            draws = [round_draws(cfg.seed, *chunk[0], rnd, cfg.batch_size, dev)
                     for rnd in range(cfg.n_rounds)]
            _, aps, picks = program(states[0], draws, relevant[0], pad, exclude[0], params,
                                    picks=True)
            aps, picks = aps[None], picks[None]
        else:
            draws = [_cohort_draws(cfg, chunk, rnd, dev) for rnd in range(cfg.n_rounds)]
            _, aps, picks = program(gp_mod.stack_states(states), draws, relevant, pad, exclude,
                                    params, picks=True)
            picks = picks.transpose(0, 1)
        return aps.cpu().numpy(), picks.cpu().numpy()  # the one host read of the chunk

    res = _run_fused(cfg, dataset, plan, dev, run_chunk, log={"sharded": mesh.size})
    res["fused"] = True
    return res


def _run_stacked(cfg, dataset, state0, params, select_kwargs, plan) -> Dict[str, Any]:
    """The cohort (``query_batch``) and fused (``fused_sessions``) modes.

    Sessions run in cohorts of ``query_batch`` (1 without it), each session
    on its own state for all of its rounds: per round one stacked selection,
    the simulated users, one :func:`~gp_mod.gp_update_stacked` and the K
    APs, with each session's own draws (:func:`round_draws`) and, with
    ``GP.learn_every``, its own re-learned hyperparameters at the serial
    path's cadence.  A short last cohort is padded to ``query_batch`` by
    repeating its first session, whose padded rows are discarded (the
    reference's rule), so it replays the full cohort's program.  Unfused,
    each round is one program
    (:func:`_cohort_rounds`, the reference's ``round_v``), its APs and picks
    come to the host and each session logs a row per round.  Fused, all the
    rounds of a cohort are one program (the reference's ``fused_v``), its
    AP curves and picks read to the host once (:func:`_run_fused`).  With
    ``GP.learn_every`` the re-learn (the K sessions' ascents as one and
    their refits, :func:`~ital_tpu_torch.models.hyperopt.relearn_stacked`)
    runs inside the program, after the AP of each round on which the
    cadence falls, as in the reference's ``round_v`` / ``fused_v``: unfused,
    such a round is a second program; fused, a cohort's rounds stay one.
    After the first re-learn every session is a hyperparameter group of its
    own (:func:`_cohort_plan`).  Every strategy's selection runs inside the
    program (its cohort program body, :func:`cohort_program`).
    ``GP.refit_every`` is ignored, as the reference ignores it here.
    """
    if cfg.gp.refit_every:
        print(_REFIT_IGNORED)
    dev = state0.mu.device
    n = dataset.n
    size = max(cfg.query_batch or 0, 1)

    def cohort(chunk):
        """The chunk padded to the cohort's size, its sessions' states and masks."""
        padded = chunk + [chunk[0]] * (size - len(chunk))
        relevant = torch.from_numpy(
            np.stack([dataset.relevance[:, c] for _, c, _ in padded])).to(dev)
        exclude = torch.zeros((size, n), dtype=torch.bool)
        exclude[torch.arange(size), torch.tensor([q for *_, q in padded])] = True
        return padded, _query_states(state0, padded), (relevant, exclude.to(dev))

    def rounds(padded, states, chunk_masks, start, stop):
        return _cohort_rounds(cfg, states, params, select_kwargs, padded, range(start, stop),
                              *chunk_masks)

    if cfg.fused_sessions:
        def run_chunk(chunk):
            padded, states, chunk_masks = cohort(chunk)
            aps, picks = rounds(padded, states, chunk_masks, 0, cfg.n_rounds)
            k = len(chunk)  # the one host sync of the cohort
            return aps[:k].cpu().numpy(), picks.transpose(0, 1)[:k].cpu().numpy()

        return _run_fused(cfg, dataset, plan, dev, run_chunk)

    logger = JsonlLogger(cfg.log_jsonl)
    timer = Timer(dev)
    ap_rows = np.zeros((len(plan), cfg.n_rounds))
    pick_rows = np.zeros((len(plan), cfg.n_rounds, cfg.batch_size), np.int64)
    try:
        for start in range(0, len(plan), size):
            chunk = plan[start:start + size]
            padded, states, chunk_masks = cohort(chunk)
            for rnd in range(cfg.n_rounds):
                with timer.span("round"):
                    aps, picks = rounds(padded, states, chunk_masks, rnd, rnd + 1)
                    aps, picks = aps[:len(chunk), 0].cpu().numpy(), picks[0, :len(chunk)].cpu()
                ap_rows[start:start + len(chunk), rnd] = aps
                pick_rows[start:start + len(chunk), rnd] = picks.numpy()
                for j, (rep, c, q) in enumerate(chunk):
                    logger.log(rep=rep, cls=c, query=q, round=rnd, ap=float(aps[j]),
                               round_ms=timer.last_ms("round"), query_batch=cfg.query_batch)
    finally:
        logger.close()
    out = _stacked_result(cfg, dataset, plan, dev, ap_rows, timer, "round")
    out["picks"] = pick_rows
    return out


_REFIT_IGNORED = ("# GP.refit_every is a serial/per-round-sharded feature; the "
                  "fused/cohort device programs keep the pure incremental append "
                  "(drift measured benign - ARCHITECTURE.md) and ignore it")


def _run_fused(cfg, dataset, plan, dev, run_chunk, *, log=None) -> Dict[str, Any]:
    """The fused modes' loop: the plan in chunks of ``query_batch`` sessions
    (1 without it), ``run_chunk(chunk) -> (curves, picks)``, the (K,
    n_rounds) AP curves and the (K, n_rounds, b) picks (or None) on the
    host, one JSONL row per session with its curve, the chunk's time
    (``session_ms`` or ``cohort_ms``) and the ``log`` fields."""
    size = max(cfg.query_batch or 0, 1)
    span = "round" if size > 1 else "session"
    logger = JsonlLogger(cfg.log_jsonl)
    timer = Timer(dev)
    ap_rows = np.zeros((len(plan), cfg.n_rounds))
    pick_rows = np.zeros((len(plan), cfg.n_rounds, cfg.batch_size), np.int64)
    picks = None
    try:
        for start in range(0, len(plan), size):
            chunk = plan[start:start + size]
            with timer.span(span):
                curves, picks = run_chunk(chunk)
            ap_rows[start:start + len(chunk)] = curves
            if picks is not None:
                pick_rows[start:start + len(chunk)] = picks
            took = round(timer.last_ms(span), 3)
            fields = ({"session_ms": took} if size == 1
                      else {"cohort_ms": took, "query_batch": cfg.query_batch})
            for j, (rep, c, q) in enumerate(chunk):
                logger.log(rep=rep, cls=c, query=q, ap_curve=[float(v) for v in curves[j]],
                           **fields, **(log or {}))
    finally:
        logger.close()
    out = _stacked_result(cfg, dataset, plan, dev, ap_rows, timer, span)
    if picks is not None:
        out["picks"] = pick_rows
    return out


def _stacked_result(cfg, dataset, plan, dev, ap_rows, timer, span) -> Dict[str, Any]:
    """The result dict of the cohort and fused modes (the reference's keys:
    ``update_ms`` 0, ``fused`` or ``query_batch``), their times per round
    from the ``span`` spans."""
    size = max(cfg.query_batch or 0, 1)
    per_round = cfg.n_rounds if span != "round" else 1
    out = {
        "ap": ap_rows,
        "map": ap_rows.mean(axis=0) if ap_rows.size else np.zeros(cfg.n_rounds),
        "select_ms": timer.ms(span) / per_round,
        "update_ms": 0.0,
        "select_ms_steady": _steady_ms(timer.median_ms(span), per_round),
        "first_round_ms": round(timer.first_ms(span), 3),
        "sessions": [{"rep": rep, "cls": c, "query": q} for rep, c, q in plan],
        "dataset": dataset.name,
        "method": cfg.method,
        "device": _device_name(dev),
    }
    out.update({"fused": True} if size == 1 else {"query_batch": cfg.query_batch})
    return out


def _query_states(state0, chunk) -> list:
    """A cohort's sessions: each set to its query on its own buffers."""
    return [gp_mod.gp_set_query(gp_mod.gp_session_copy(state0), q) for _, _, q in chunk]


def _cohort_draws(cfg, chunk, rnd, dev):
    """Round ``rnd``'s draws of each session of a cohort: the generators and
    the users' (K, b) uniforms."""
    draws = [round_draws(cfg.seed, rep, c, q, rnd, cfg.batch_size, dev) for rep, c, q in chunk]
    return ([d[0] for d in draws], torch.stack([d[1] for d in draws]),
            torch.stack([d[2] for d in draws]))


def _cohort_plan(cfg: ExperimentConfig, k: int, rnd: int) -> list:
    """The group plan of a cohort of ``k`` sessions at round ``rnd``: one
    group until its first re-learn (every session starts from the run's
    hyperparameters), each session its own after it.  Known without
    reading the hyperparameters back, and the same for a padded cohort."""
    if cfg.gp.learn_every and rnd >= cfg.gp.learn_every:
        return [[j] for j in range(k)]
    return [list(range(k))]


def _rounds_body(x, density=None, *, select, drawn, groups, rounds, learn_after, learn, u_label,
                 u_flip, relevant, exclude, center, **inputs) -> tuple:
    """``rounds`` rounds of a cohort as a program's body: each round's
    selection by ``select`` (a :class:`~ital_tpu_torch.select.base.
    CohortProgram`'s picks) with round r of its fed inputs named ``drawn``
    (R, K, ...); the users' answers from the fed uniforms (R, K, b), the
    stacked update (in place) and the K APs; after the AP of each round in
    ``learn_after``, the K sessions' re-learn and refit with the ascent's
    options ``learn`` and the prior's (3,) ``center`` (or None).  Returns
    the (K, R) APs, the (R, K, b) picks and, where the program re-learns,
    the (K, 3) final (length_scale, var, noise)."""
    fed = {name: inputs.pop(name) for name in drawn}
    st = gp_mod.program_stack(x, inputs, groups, density)
    params = StrategyParams.from_inputs(inputs)
    aps, batches = [], []
    for r in range(rounds):
        batch = select(st, params, **{k: None if v is None else v[r] for k, v in fed.items()})
        y, valid = feedback_from_uniforms(u_label[r], u_flip[r], batch, relevant,
                                          params.label_prob, params.mistake_prob)
        gp_mod.gp_update_stacked(st, batch, y, valid)
        aps.append(average_precision(st.mu, relevant, exclude))
        batches.append(batch)
        if r in learn_after:
            relearn_stacked(st, center=center, **dict(learn))
    out = (torch.stack(aps, 1), torch.stack(batches))
    if learn_after:
        h = st.hyper
        out += (torch.stack([h.length_scale, h.var, h.noise], -1),)
    return out


def _cohort_rounds(cfg, states, params, select_kwargs, chunk, rnds, relevant, exclude):
    """Rounds ``rnds`` of a cohort of sessions ``states`` (written in place),
    each followed by the re-learn where the cadence falls (after the AP, as
    the serial path).  Returns the (K, R) APs and (R, K, b) picks on the
    device.

    The rounds are one program (:func:`ital_tpu_torch.graphs.run`), the
    counterpart of the reference's ``round_v`` (one round) or ``fused_v``
    (all of a session's rounds), which stacks the sessions' buffers inside
    and selects and re-learns inside: the strategy's cohort program body
    (:func:`cohort_program`), every round's draws (each session's from its
    own generator, in its own selection's order) made before and fed in
    with the users' uniforms.  After a re-learn each session takes new 0-d
    hyperparameters from the program's output."""
    x, dev, b = states[0].x, states[0].mu.device, cfg.batch_size
    draws = [_cohort_draws(cfg, chunk, rnd, dev) for rnd in rnds]
    select = cohort_program(cfg.method, b, select_kwargs)
    drawn = [select.draw(gens, x.shape[0], states[0].mu.dtype, dev) for gens, _, _ in draws]
    fed = {k: None if drawn[0][k] is None else torch.stack([d[k] for d in drawn])
           for k in drawn[0]}
    groups = _cohort_plan(cfg, len(states), rnds[0])
    inputs, groups = gp_mod.cohort_program_inputs(states, groups)
    every = cfg.gp.learn_every
    learn_after = tuple(r for r, rnd in enumerate(rnds) if every and (rnd + 1) % every == 0)
    learn = LearnConfig.from_gp(cfg.gp) if learn_after else None
    inputs.update(params.program_inputs(), **fed,
                  u_label=torch.stack([d[1] for d in draws]),
                  u_flip=torch.stack([d[2] for d in draws]), relevant=relevant, exclude=exclude,
                  center=learn.center_of(states[0].mu) if learn else None)
    name = "fused_session" if cfg.fused_sessions else "cohort_round"
    options = learn.options() if learn else ()
    aps, batches, *hyper = graphs.run(
        name, functools.partial(_rounds_body, select=select.picks, drawn=tuple(fed),
                                groups=groups, rounds=len(rnds), learn_after=learn_after,
                                learn=options),
        inputs, shared=gp_mod.program_shared(states[0]), writes=gp_mod.SESSION_FIELDS,
        static=(cfg.method, b, len(rnds), select.static, groups, learn_after, options))
    for k, s in enumerate(states):
        s.count += b * len(rnds)
        if hyper:
            s.hyper = gp_mod.GPHyper(*hyper[0][k].unbind())
    return aps, batches


def _learn_kwargs(cfg: ExperimentConfig, state: gp_mod.GPState) -> Dict[str, Any]:
    """``fit_hyperparams`` options from the config (:class:`LearnConfig`):
    the MAP type-II prior is anchored at the config's initial
    hyperparameters, not the current iterate, which would let it wander."""
    return LearnConfig.from_gp(cfg.gp).fit_kwargs(state.mu)


def _relearn_hyperparams(state: gp_mod.GPState, cfg: ExperimentConfig) -> gp_mod.GPState:
    """Re-learn the hyperparameters from the session's labels so far (type-II
    ML, or MAP type-II with the ``GP.learn_*`` knobs), then refit the
    posterior: one program, the ascent and the refit
    (:func:`~ital_tpu_torch.models.hyperopt.relearn`)."""
    relearn(state, **_learn_kwargs(cfg, state))
    return state


def _relearn_on_mesh(state: gp_mod.GPState, cfg: ExperimentConfig, *, rows: Callable,
                     refit: Callable) -> gp_mod.GPState:
    """:func:`_relearn_hyperparams` on the large-cap mesh (the reference's
    ``_relearn_hyperparams`` with ``refit=bigcap_refit``): every rank learns
    alike from the labeled rows ``rows(state)`` gathers (a program of the
    mesh), the ascent a program of its own, then refits with ``refit`` (the
    large-cap path's distributed refit, a program of the mesh)."""
    state.hyper = fit_hyperparams(rows(state), state.y, state.active, state.hyper,
                                  **_learn_kwargs(cfg, state))
    return refit(state)


def _hyper_log_fields(state: gp_mod.GPState, cfg: ExperimentConfig) -> Dict[str, float]:
    """The learned hyperparameters' JSONL fields (none when learning is off)."""
    if not cfg.gp.learn_every:
        return {}
    h = state.hyper
    return {"length_scale": round(float(h.length_scale), 4),
            "gp_var": round(float(h.var), 4),
            "gp_noise": round(float(h.noise), 4)}


def _maybe_inject_fault(rnd: int) -> None:
    """``ITAL_TPU_FAULT_AFTER_ROUND=r`` hard-kills the process (``os._exit(17)``,
    no cleanup) after round ``r`` completes: the crash-resume drill, the same
    variable for both packages."""
    fault = os.environ.get("ITAL_TPU_FAULT_AFTER_ROUND")
    if fault is not None and rnd == int(fault):
        print(f"# fault injection: dying after round {rnd}", flush=True)
        os._exit(17)


def run_regression_experiment(cfg: ExperimentConfig, *, device) -> Dict[str, Any]:
    """Active GP-regression experiment on ``device``: RMSE of the posterior mean per round.

    No query image: each session starts with an empty labeled set; each
    round the strategy (``ital_regression`` by default) picks a batch, and the
    simulated user reports the true value with probability ``label_prob``,
    plus N(0, USER.obs_noise) error (GP.noise when unset).  ``GP.learn_every``
    re-learns the hyperparameters as in :func:`run_experiment`; the result
    then carries the last repetition's final values under ``"hyper"``.
    """
    dev = torch.device(device)
    _check_capacity(cfg, query_slots=0)
    apply_matmul_precision(cfg)
    ds = ds_mod.regression_toy(**cfg.dataset_kwargs)
    x = torch.from_numpy(ds.x).to(dev)
    y_true = torch.from_numpy(ds.y).to(dev)

    state0 = gp_mod.gp_init(x, cfg.gp.length_scale, cfg.gp.var, cfg.gp.noise, cfg.cap,
                            corpus_dtype=cfg.gp.corpus_dtype or None)
    select = get_strategy(cfg.method)
    params = StrategyParams.create(dev, label_prob=cfg.user.label_prob,
                                   mistake_prob=cfg.user.mistake_prob)
    # The generative noise is a constant of the simulation, never the model's.
    gen_sd = torch.sqrt(torch.tensor(cfg.user.obs_noise or cfg.gp.noise,
                                     dtype=state0.mu.dtype, device=dev))

    curves = []
    for rep in range(cfg.repetitions):
        state = gp_mod.gp_session_copy(state0)
        curve = []
        for rnd in range(cfg.n_rounds):
            generator, u_label, eps = regression_draws(cfg.seed, rep, rnd, cfg.batch_size, dev)
            batch = select(state, cfg.batch_size, generator, params)
            y_obs = y_true[batch] + gen_sd * eps
            state = gp_mod.gp_update(state, batch, y_obs, u_label < params.label_prob)
            curve.append(float(torch.sqrt(torch.mean((state.mu - y_true) ** 2))))
            if cfg.gp.learn_every and (rnd + 1) % cfg.gp.learn_every == 0:
                state = _relearn_hyperparams(state, cfg)
        curves.append(curve)
    rmse = np.asarray(curves)
    out = {
        "rmse": rmse,
        "mean_rmse": rmse.mean(axis=0),
        "dataset": ds.name,
        "method": cfg.method,
        "device": _device_name(dev),
    }
    if cfg.gp.learn_every:
        h = state.hyper
        out["hyper"] = {"length_scale": float(h.length_scale), "var": float(h.var),
                        "noise": float(h.noise)}
    return out

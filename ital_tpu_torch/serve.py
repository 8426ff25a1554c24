"""HTTP serving layer for interactive retrieval sessions (port of ``ital_tpu.serve``).

A small stdlib-only HTTP front end over
:class:`ital_tpu_torch.models.session.ActiveRetrieval`.  One process owns the
card; the corpus is one device tensor shared by every session (features are
never copied per session), and on the card every RBF block of a request goes
through the hand-written kernel.

With ``mesh_devices = p`` (``--mesh p``) the corpus is padded to the mesh and
sharded over p devices, one rank each (:class:`ital_tpu_torch.parallel.
interactive.MeshWorld`): rank 0 is this process, which holds only its shard,
and a mesh of p > 1 starts p - 1 worker ranks.  Sessions are
:class:`~ital_tpu_torch.parallel.interactive.ShardedRetrieval`, every request
runs as one command on every rank, and the cohort endpoints run one sharded
cohort selection (``parallel.sharded.make_sharded_cohort_select``) or update
(``make_sharded_cohort_update``) per group.  Batches, rankings, snapshots and
learned values are the single-device service's.

Concurrency:

* Each session has its own lock; the registry lock guards only the session
  dict, the id counter and the density cache.  Requests for different
  sessions contend only on the device.
* Session updates write the session's buffers in place, so
  ``GET /sessions/<id>/snapshot`` copies them to the host under the session
  lock and serializes the copy outside every lock: a concurrent
  ``/feedback`` can neither tear the snapshot nor wait on its serialization.
* The cohort endpoints ``POST /batch_select`` and ``POST /batch_feedback``
  take many sessions in one request, lock them in one canonical order
  (duplicates dropped first) and keep each session's own semantics: its own
  generator, user model, feedback bucket width and capacity error.  A
  compatible group (same strategy, capacity, options and density) selects
  with one stacked selection over the shared corpus, whatever its
  sessions' user models (:func:`ital_tpu_torch.select.base.
  get_stacked_strategy`; ITAL's is :func:`ital_tpu_torch.select.ital.
  select_ital_stacked`), and the sessions of one (width, capacity)
  feedback group take one stacked GP update
  (:func:`ital_tpu_torch.models.gp.update_stacked`), written back into
  each session's buffers under its lock.  On the card every stacked
  selection and every stacked update each replay one captured program
  (:mod:`ital_tpu_torch.graphs`), which stacks the sessions' buffers inside
  itself.  A group is laid out by hyperparameter group first, larger groups
  first, so that its program depends on its size and the sizes of its
  hyperparameter groups alone; the programs of every signature stack into
  shared stages, which keep at most ``graphs.STACK_BYTES``.  Groups larger
  than the memory budget (``ITAL_TPU_COHORT_STATE_BYTES``,
  :meth:`RetrievalService._max_cohort_sessions`) run as several stacked
  programs, with the same results.
* On a mesh service one lock orders every mesh command, since every rank
  must issue its collectives in the same order: requests for different
  sessions serialize at the mesh, not only at the device.  The session
  locks are taken first, then the mesh lock.

While tracing is on (:mod:`ital_tpu_torch.utils.logging`), each call of
``create_session``, ``set_query``, ``feedback``, ``feedback_many``,
``next_batch``, ``next_batch_many`` and ``delete`` is one request, a span
``serve.<method>``, and the picks' read to the host inside it is the span
``serve.picks.wait``.

API (JSON bodies)::

    GET  /healthz                          -> {"ok": true, "corpus": ..., "n": N}
    POST /sessions        {"strategy"?, "cap"?, "label_prob"?, "mistake_prob"?,
                           "length_scale"?, "var"?, "noise"?, "method_kwargs"?}
                                           -> {"session_id": "s0"}
    POST /sessions/<id>/query    {"index": 123}        (query image = +1 label)
    GET  /sessions/<id>/batch?k=4          -> {"batch": [..]}   next to label
    POST /batch_select    {"session_ids": ["s0", "s1"], "k": 4}
                                           -> {"batches": {"s0": [..], ...}}
    POST /sessions/<id>/feedback {"labels": {"17": 1, "40": -1}}
                                           -> {"labeled": n}
    POST /batch_feedback  {"feedback": {"s0": {"17": 1}, ...}}
                                           -> {"sessions": {"s0": {"labeled": n}
                                                            or {"error": ...}}}
    GET  /sessions/<id>/ranking?k=20       -> {"top": [..], "scores": [..]}
    POST /sessions/<id>/learn    {"steps"?: 50, "prior_strength"?: 0.0,
                                  "noise_floor"?: 0.0}
                                           -> learned hyperparameters
    GET  /sessions/<id>/snapshot           -> npz bytes
    POST /sessions/restore       (npz bytes) -> {"session_id": ...}
    DELETE /sessions/<id>

Unknown sessions and routes answer 404, malformed bodies 400, other
failures 500.

Start: ``python -m ital_tpu_torch.serve configs/digits.ini --port 8080
[--device cpu]`` (console script ``ital-tpu-torch-serve``); the config's
[DATA]/[GP]/[USER]/[EXPERIMENT]/[METHOD] sections supply the corpus,
hyperparameters, user model, default strategy and its options.
``--device`` defaults to ``cuda`` and fails without a card; ``--mesh N``
shards the corpus over N cards (or, with ``--device cpu``, N gloo processes).
"""

from __future__ import annotations

import dataclasses
import functools
import io
import json
import os
import re
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np
import torch

from ital_tpu_torch.models import gp as gp_mod
from ital_tpu_torch.models.session import ActiveRetrieval, resolve_device
from ital_tpu_torch.parallel import interactive
from ital_tpu_torch.parallel import sharded as sh
from ital_tpu_torch.runner import DENSITY_STRATEGIES
from ital_tpu_torch.select.base import (
    StrategyParams,
    filter_method_kwargs,
    get_stacked_strategy,
)
from ital_tpu_torch.utils import checkpoint as ckpt
from ital_tpu_torch.utils.logging import span

# Peak device memory a stacked cohort program adds per session: copies of
# the session's (cap, N) f32 whitened buffer v (the stack and the
# corpus-wide temporaries, which grow with N) plus fixed bytes that do not
# grow with N.  From the rise of torch.cuda.max_memory_allocated over K = 8
# sessions on an H100 80GB HBM3 at 700 W (chip_smoke.py; PERF.md).  ITAL's
# selection at the production settings (cap 64, pool 4096; phases 8 and 9)
# added 95.55 MiB a session at 25 000 rows and 115.13 MiB at 100 000, which
# fit 1.07 copies + 89.0 MiB (the MI scan over the session's pool); an
# update 1.26 and 1.24 copies.  Rounded up.  At 1M rows over a bfloat16
# corpus (phase 15) a selection added 281.16-289.21 MiB a session, under
# the fit's 350.23 and this entry's 401.18; an update 1.24-1.25 copies.
SELECT_BUDGET = {"ital": (1.25, 96 << 20)}
# Each other strategy's selection at the harness's settings, cap 64 and
# 25 000 rows (chip_smoke.py phase 14): the measured rise plus 15 %,
# rounded up to a quarter copy.  Every temporary of theirs grows with N, so
# the whole rise counts in copies.  Measured, in copies: 1.07-1.13 for the
# batch-independent scores, 1.21 ital_regression, 3.05 for the diversity
# penalties' (N, cap) blocks, 13.09 emoc, 14.89 emoc_batch and 11.07
# mcmi_min, most of these three their (N, block) blocks, which a program
# holds once for all of its sessions (over 8 here).
SELECT_BUDGET.update({
    **dict.fromkeys(("random", "topscoring", "variance_sampling", "uncertainty_sampling",
                     "borderline_sampling"), (1.25, 0)),
    **dict.fromkeys(("entropy_sampling", "sud", "adapt_al", "ital_regression"), (1.5, 0)),
    **dict.fromkeys(("borderline_diversity_sampling", "usdm", "tcal", "rbmal"), (3.75, 0)),
    "emoc": (15.25, 0), "emoc_batch": (17.25, 0), "mcmi_min": (12.75, 0),
})
UPDATE_COPIES = 2
# The default of ITAL_TPU_COHORT_STATE_BYTES, the device memory a stacked
# program may take beyond the live sessions and the corpus: a tenth of the
# H100's 80 GB.  At cap 64 a selection then takes 79 sessions at a time at
# 25 000 rows and 20 at 1M rows, an update 671 and 16.
COHORT_STATE_BYTES = 8 << 30


def max_cohort_sessions(cap: int, n: int, copies: float, fixed_bytes: int = 0) -> int:
    """Largest session group one stacked program over an (n,)-row corpus
    (on a mesh, one rank's shard) takes: the budget
    (``ITAL_TPU_COHORT_STATE_BYTES``, default :data:`COHORT_STATE_BYTES`)
    over ``copies`` (cap, n) f32 buffers plus ``fixed_bytes`` a session
    (a strategy's :data:`SELECT_BUDGET` entry, :data:`UPDATE_COPIES`)."""
    budget = int(os.environ.get("ITAL_TPU_COHORT_STATE_BYTES", COHORT_STATE_BYTES))
    return max(1, int(budget // (copies * int(cap) * int(n) * 4 + fixed_bytes)))


def _request(method):
    """``method`` of the service as one request: the span ``serve.<name>``."""
    name = f"serve.{method.__name__}"

    @functools.wraps(method)
    def call(*args, **kwargs):
        with span(name):
            return method(*args, **kwargs)

    return call


class NotFound(KeyError):
    """Unknown session id or route: HTTP 404 (other KeyErrors, from malformed
    bodies, are 400)."""


def _parse_labels(labels: Dict[str, int]) -> Dict[int, Optional[int]]:
    """A request's ``{"index": label}`` as the session's feedback dict
    (0 or null: skipped)."""
    return {int(i): (None if v in (0, None) else int(v)) for i, v in labels.items()}


def _density_compatible(sessions) -> bool:
    """True when the group shares one corpus density: all without, or all
    with the one built at the same length scale (its only input)."""
    dens = [s.state.density for s in sessions]
    if all(d is None for d in dens):
        return True
    if any(d is None for d in dens):
        return False
    keys = {getattr(s, "_density_ls", None) for s in sessions}
    return None not in keys and len(keys) == 1


class RetrievalService:
    """Session registry over one shared corpus: the HTTP-agnostic core.

    ``x`` (N, D) is a NumPy array or a tensor; it goes to ``device`` (default
    ``cuda``; without a card that raises) once, as float32 or, with
    ``corpus_dtype="bfloat16"``, as bfloat16.  ``method_kwargs`` are the
    default strategy options of every session (the config's [METHOD]
    section); each session keeps those its strategy declares.
    ``mesh_devices = p`` shards the corpus over a mesh of p devices of
    ``device``'s type (this process is rank 0 and holds only its shard);
    :meth:`close` then stops the mesh's workers and its process group.
    """

    def __init__(
        self,
        x,
        *,
        length_scale: float,
        var: float = 1.0,
        noise: float = 0.1,
        cap: int = 64,
        strategy: str = "ital",
        label_prob: float = 1.0,
        mistake_prob: float = 0.0,
        corpus_name: str = "corpus",
        method_kwargs: Optional[dict] = None,
        mesh_devices: int = 0,
        corpus_dtype: str = "",
        device=None,
    ):
        dev = resolve_device(device)
        self._world: Optional[interactive.MeshWorld] = None
        if mesh_devices:
            x_np = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x
            self._world = interactive.MeshWorld(int(mesh_devices), x_np, device=dev,
                                                corpus_dtype=corpus_dtype)
            # Rank 0's shard: the only corpus rows this process holds.
            self.x = self._world.ctx.x
            self.n_real = self._world.ctx.n_real
        else:
            if isinstance(x, torch.Tensor):
                xt = x.to(dev, torch.float32)
            else:
                xt = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
            if corpus_dtype and corpus_dtype != "float32":
                xt = xt.to(getattr(torch, corpus_dtype))
            # The one device copy: sessions keep this tensor as their corpus.
            self.x = xt.contiguous()
            self.n_real = int(self.x.shape[0])
        self.defaults = dict(
            length_scale=length_scale, var=var, noise=noise, cap=cap,
            strategy=strategy, label_prob=label_prob, mistake_prob=mistake_prob,
        )
        self.method_kwargs = dict(method_kwargs or {})
        self.corpus_name = corpus_name
        # sid -> (ActiveRetrieval or ShardedRetrieval, its lock).
        self._sessions: Dict[str, tuple] = {}
        self._next = 0
        self._lock = threading.Lock()
        # The corpus density, built once per length scale (its only input)
        # and shared by every density-strategy session at that scale.  On a
        # mesh each rank keeps its own shard of it (MeshContext).
        self._density_by_ls: Dict[float, torch.Tensor] = {}

    def health(self) -> dict:
        return {"ok": True, "corpus": self.corpus_name, "n": self.n_real,
                "sessions": len(self._sessions),
                "mesh_devices": 0 if self._world is None else self._world.mesh.size,
                "device": str(self.x.device)}

    def close(self) -> None:
        """Stop a mesh service's worker ranks and destroy its process group
        (nothing to do on one device); idempotent."""
        if self._world is not None:
            self._world.close()

    def _mesh(self, sid: str, fn, *args):
        """Run a mesh command for session ``sid``, whose lock the caller
        holds (so no delete of it runs meanwhile)."""
        if sid not in self._world.ctx.sessions:
            raise NotFound(f"no such session {sid!r}")
        return self._world.run(fn, sid, *args)

    @_request
    def create_session(self, **overrides) -> str:
        """A new session over the shared corpus; ``overrides`` replace the
        service's defaults, and ``method_kwargs`` layer over its options
        (the session's constructor rejects names its strategy does not
        declare, and a mesh session options the mesh does not take)."""
        mkw_over = overrides.pop("method_kwargs", None)
        cfg = {**self.defaults, **{k: v for k, v in overrides.items() if v is not None}}
        strategy = str(cfg["strategy"])
        kwargs = dict(
            length_scale=float(cfg["length_scale"]), var=float(cfg["var"]),
            noise=float(cfg["noise"]), cap=int(cfg["cap"]), strategy=strategy,
            label_prob=float(cfg["label_prob"]), mistake_prob=float(cfg["mistake_prob"]),
            method_kwargs={**filter_method_kwargs(strategy, self.method_kwargs),
                           **(mkw_over or {})},
        )
        density_ls = float(cfg["length_scale"]) if strategy in DENSITY_STRATEGIES else None
        if self._world is not None:
            interactive.check_mesh_options(strategy, kwargs["method_kwargs"])
            with self._lock:
                sid = f"s{self._next}"
                self._next += 1
            sess = self._world.run(_mesh_create, sid, kwargs, density_ls)
            with self._lock:
                self._sessions[sid] = (sess, threading.Lock())
            return sid
        sess = ActiveRetrieval(self.x, **kwargs)
        if density_ls is not None:
            # Built outside the registry lock, which guards only dict reads and
            # writes; racing creators may both build it, and the first insert
            # wins (the two are the same values).
            with self._lock:
                dens = self._density_by_ls.get(density_ls)
            if dens is None:
                dens = gp_mod.corpus_density(sess.state)
                with self._lock:
                    dens = self._density_by_ls.setdefault(density_ls, dens)
            sess.state.density = dens
            # The cohort-compatibility key of the shared vector.
            sess._density_ls = density_ls
        with self._lock:
            sid = f"s{self._next}"
            self._next += 1
            self._sessions[sid] = (sess, threading.Lock())
        return sid

    def _entry(self, sid: str) -> tuple:
        with self._lock:
            entry = self._sessions.get(sid)
        if entry is None:
            raise NotFound(f"no such session {sid!r}")
        return entry

    def _lock_group(self, sids) -> list:
        """``(sid, session, lock)`` of each distinct id, all locked in one
        canonical order (deadlock-free against concurrent groups); the caller
        releases them with :meth:`_unlock_group`."""
        entries = [(sid, *self._entry(sid)) for sid in dict.fromkeys(sids)]
        for _, _, lock in sorted(entries, key=lambda e: e[0]):
            lock.acquire()
        return entries

    @staticmethod
    def _unlock_group(entries) -> None:
        for _, _, lock in entries:
            lock.release()

    @_request
    def set_query(self, sid: str, index: int) -> None:
        sess, lock = self._entry(sid)
        with lock:
            if self._world is None:
                sess.update_query(int(index))
                return
            if not 0 <= int(index) < self.n_real:
                raise ValueError(f"query index {index} outside the corpus of {self.n_real}")
            self._mesh(sid, _mesh_set_query, int(index))

    @_request
    def next_batch(self, sid: str, k: int) -> list:
        sess, lock = self._entry(sid)
        with lock:
            return self._fetch_locked(sid, sess, int(k))

    def _fetch_locked(self, sid: str, sess, k: int) -> list:
        if self._world is None:
            return [int(i) for i in sess.fetch_unlabelled(k)]
        # Every rank selects from rank 0's generator state.
        return self._mesh(sid, _mesh_select, k, sess.generator.get_state())

    def _max_cohort_sessions(self, cap: int, copies: float, fixed_bytes: int = 0) -> int:
        """:func:`max_cohort_sessions` over this service's corpus: on a mesh,
        over rank 0's shard, since each rank holds its (cap, N/p) columns of
        every stacked copy.  The fixed term stays whole: each rank scores
        only its slice of a pool, but the gathered pool and the refinement
        are whole on every rank, so it bounds a rank's MI temporaries."""
        return max_cohort_sessions(cap, self.x.shape[0], copies, fixed_bytes)

    @_request
    def next_batch_many(self, sids: list, k: int) -> Dict[str, list]:
        """Select for many sessions in one request.

        A compatible group (identical strategy, capacity, options and shared
        density) goes to :meth:`_select_cohort_locked`, in chunks of at most
        :meth:`_max_cohort_sessions`; a mixed one, or a single session,
        selects per session.  Either way each session draws from its own
        generator, so the batches are those of one ``GET /batch`` per
        session.
        """
        entries = self._lock_group(sids)
        try:
            sessions = [s for _, s, _ in entries]
            compatible = (
                len({s.strategy_name for s in sessions}) == 1
                and len({s.state.cap for s in sessions}) == 1
                and len({tuple(sorted(s.method_kwargs.items())) for s in sessions}) == 1
                and _density_compatible(sessions)
            )
            if not compatible or len(sessions) == 1:
                return {sid: self._fetch_locked(sid, s, int(k)) for sid, s, _ in entries}
            limit = self._max_cohort_sessions(sessions[0].state.cap,
                                              *SELECT_BUDGET[sessions[0].strategy_name])
            out: Dict[str, list] = {}
            for i in range(0, len(entries), limit):
                out.update(self._select_cohort_locked(entries[i:i + limit], int(k)))
            return out
        finally:
            self._unlock_group(entries)

    def _select_cohort_locked(self, entries, k: int) -> Dict[str, list]:
        """A compatible, locked group's selection: one stacked selection
        program of the group's sessions, each drawing from its own
        generator, with its own user model where they differ (the
        reference's ``params_b``); on a mesh one command, whose program is
        the sharded cohort selection of the whole group."""
        group = _by_hyper_group(entries)
        sessions = [s for _, s, _ in group]
        if self._world is not None:
            rows = self._world.run(_mesh_cohort_select, [sid for sid, _, _ in group], k,
                                   [s.generator.get_state() for s in sessions])
        else:
            name = sessions[0].strategy_name
            picks = get_stacked_strategy(name)(
                [s.state for s in sessions], k, [s.generator for s in sessions],
                _group_params(sessions),
                **filter_method_kwargs(name, sessions[0].method_kwargs))
            with span("serve.picks.wait"):
                rows = picks.tolist()
        return {sid: [int(i) for i in row] for (sid, _, _), row in zip(group, rows)}

    @_request
    def feedback(self, sid: str, labels: Dict[str, int]) -> dict:
        sess, lock = self._entry(sid)
        with lock:
            parsed = _parse_labels(labels)
            if self._world is None:
                sess.update(parsed)
            elif parsed:
                self._mesh(sid, _mesh_absorb, *sess.feedback_block(parsed))
            return {"labeled": int(sess.state.count)}

    @_request
    def feedback_many(self, fb: Dict[str, Dict[str, int]]) -> Dict[str, dict]:
        """Absorb many sessions' feedback in one request.

        Every label dict is parsed before any state changes: a malformed one
        rejects the whole request.  After that each session is on its own:
        its block pads to its own bucket width, clamped to its remaining
        capacity, as ``POST /feedback`` would; an empty dict changes nothing;
        a session whose labels overflow its capacity gets an ``{"error": ...}``
        entry while the others are applied.  The sessions of one (width,
        capacity) group take one stacked GP update per chunk of at most
        :meth:`_max_cohort_sessions`, whatever their counts and
        hyperparameters (on a mesh, one sharded cohort update).
        """
        for sid in fb:
            self._entry(sid)  # an unknown session is a 404 before anything else
        parsed = {sid: _parse_labels(labels) for sid, labels in fb.items()}
        entries = self._lock_group(fb)
        try:
            out: Dict[str, dict] = {}
            groups: Dict[tuple, list] = {}
            for sid, s, _ in entries:
                labels = parsed[sid]
                used, cap = s.state.count, s.state.cap
                if labels and used + len(labels) > cap:
                    out[sid] = {"error": (f"labeled-slot capacity exceeded: {used} used + "
                                          f"{len(labels)} new > cap={cap}")}
                elif labels:
                    idx, y = s.feedback_block(labels)
                    groups.setdefault((len(idx), cap), []).append((sid, s, idx, y))
            for (_, cap), group in groups.items():
                limit = self._max_cohort_sessions(cap, UPDATE_COPIES)
                for i in range(0, len(group), limit):
                    self._update_cohort_locked(group[i:i + limit])
            return {sid: out.get(sid, {"labeled": int(s.state.count)}) for sid, s, _ in entries}
        finally:
            self._unlock_group(entries)

    def _update_cohort_locked(self, group) -> None:
        """One stacked GP update of locked sessions ``(sid, session, idx, y)``
        with feedback blocks of one width, written back into each session's
        own buffers once the whole update has succeeded."""
        group = _by_hyper_group(group)
        idx = np.stack([i for _, _, i, _ in group])
        y = np.stack([y for _, _, _, y in group])
        if self._world is not None:
            self._world.run(_mesh_cohort_update, [sid for sid, *_ in group], idx, y)
            return
        dev = self.x.device
        gp_mod.update_stacked([s.state for _, s, _, _ in group], torch.as_tensor(idx, device=dev),
                              torch.as_tensor(y, device=dev), torch.as_tensor(y != 0, device=dev))

    def ranking(self, sid: str, k: int) -> dict:
        sess, lock = self._entry(sid)
        with lock:
            if self._world is None:
                top = sess.top_k(int(k))
                values = sess.scores()[top]
            else:
                top, values = self._mesh(sid, _mesh_ranking, int(k))
        return {"top": [int(i) for i in top], "scores": [round(float(v), 6) for v in values]}

    def learn(self, sid: str, steps: int = 50, prior_strength: float = 0.0,
              noise_floor: float = 0.0) -> dict:
        if prior_strength < 0 or noise_floor < 0:
            raise ValueError("prior_strength/noise_floor must be >= 0")
        kw = dict(steps=int(steps), prior_strength=float(prior_strength),
                  noise_floor=float(noise_floor))
        sess, lock = self._entry(sid)
        with lock:
            if self._world is None:
                return sess.learn_hyperparams(**kw)
            # The fit runs here on the gathered rows, so a fit that fails
            # fails the request before any rank changes the session.
            vals = sess.fit_hyperparams(self._mesh(sid, _mesh_labeled_rows), **kw)
            self._mesh(sid, _mesh_refit, vals)
            return dict(zip(("length_scale", "var", "noise"), vals))

    @_request
    def delete(self, sid: str) -> None:
        with self._lock:
            entry = self._sessions.get(sid)
        if entry is None:
            return
        with entry[1]:
            with self._lock:
                self._sessions.pop(sid, None)
            if self._world is not None and sid in self._world.ctx.sessions:
                self._world.run(_mesh_delete, sid)

    # -- snapshot / restore (failover through utils.checkpoint) -------------

    def snapshot(self, sid: str) -> bytes:
        """A session (everything but the shared corpus) as npz bytes; on a
        mesh, gathered over the padded corpus (the reference mesh service's
        layout).

        The session's buffers are copied to the host under its lock, since
        updates write them in place; serialization runs outside every lock.
        """
        sess, lock = self._entry(sid)
        with lock:
            if self._world is None:
                state = gp_mod.gp_session_copy(sess.state, device="cpu")
            else:
                state = self._mesh(sid, _mesh_snapshot)
            q = -1 if sess.query is None else int(sess.query)
            mkw = dict(sess.method_kwargs)
        with tempfile.TemporaryDirectory() as d:
            p = os.path.join(d, "session.npz")
            ckpt.save_session(p, state, extra={
                "query": np.asarray(q),
                # The session's effective options (service defaults merged
                # in): a restore onto a service with other defaults keeps them.
                "method_kwargs": np.asarray(json.dumps(mkw)),
            })
            with open(p, "rb") as fh:
                return fh.read()

    def restore(self, blob: bytes) -> str:
        """A new session from :meth:`snapshot` bytes over the same corpus
        (on a mesh, re-laid over the mesh).

        Capacity and strategy options come from the snapshot; strategy and
        user model from the service's defaults.
        """
        with np.load(io.BytesIO(blob)) as npz:
            cap = int(npz["state_idx"].shape[0])
            rows = int(npz["state_mu"].shape[0])
        if self._world is not None and rows != self._world.ctx.n_pad:
            raise ValueError(f"a snapshot over {rows} rows does not fit this mesh service's "
                             f"{self._world.ctx.n_pad} padded rows")
        sid = self.create_session(cap=cap)
        sess, lock = self._entry(sid)
        with lock:
            if self._world is not None:
                self._mesh(sid, _mesh_restore, blob)
            else:
                _restore_into(sess, sid, *ckpt.load_session(io.BytesIO(blob), sess.state))
        return sid


def _restore_into(sess, sid: str, state, extra) -> None:
    """Give ``sess`` a restored ``state`` and the snapshot's query and options."""
    sess.state = state
    q = int(extra["query"]) if "query" in extra else -1
    sess.query = None if q < 0 else q
    if "method_kwargs" in extra:
        # Replaced, not merged: the snapshot holds the merge that was in
        # force when it was taken.
        sess.method_kwargs = json.loads(str(extra["method_kwargs"]))
    if state.density is not None:
        # The restored density may come from another length scale than this
        # service's; a unique key keeps the session out of cohort groups.
        sess._density_ls = ("restored", sid)


def _group_params(sessions) -> StrategyParams:
    """A cohort's user models: the one they share, else each session's own
    as (K,) fields (:meth:`StrategyParams.stack`, the reference's
    ``params_b``)."""
    if len({s.params_key for s in sessions}) == 1:
        return sessions[0].params
    return StrategyParams.stack([s.params for s in sessions])


def _by_hyper_group(entries: list) -> list:
    """Locked group entries ``(sid, session, ...)`` in the order that lays
    their sessions out by hyperparameter group, larger groups first
    (:func:`~ital_tpu_torch.models.gp.hyper_group_order`): a stacked
    program's group plan then depends on the group sizes alone, not on the
    order of the request's sessions."""
    return [entries[k] for k in gp_mod.hyper_group_order([e[1].state for e in entries])]


# -- mesh commands: run on every rank of a mesh service (MeshWorld.run) -------


def _mesh_create(ctx, sid: str, kwargs: dict, density_ls: Optional[float]):
    sess = interactive.ShardedRetrieval(ctx.x, ctx.n_real, ctx.n_pad, ctx.mesh, **kwargs)
    if density_ls is not None:
        dens = ctx.density_by_ls.get(density_ls)
        if dens is None:
            dens = sh.make_sharded_density(ctx.mesh)(sess.state, ctx.pad)
            ctx.density_by_ls[density_ls] = dens
        sess.state.density = dens
        sess._density_ls = density_ls
    ctx.sessions[sid] = sess
    return sess


def _mesh_set_query(ctx, sid: str, index: int) -> None:
    ctx.sessions[sid].update_query(index)


def _mesh_select(ctx, sid: str, k: int, generator_state) -> list:
    sess = ctx.sessions[sid]
    sess.generator.set_state(generator_state)
    return [int(i) for i in sess.fetch_unlabelled(k)]


def _mesh_cohort_select(ctx, sids: list, k: int, generator_states) -> list:
    """One sharded cohort selection program of the sessions ``sids``, each
    with its own generator and user model; the program stacks their own
    buffers inside."""
    sessions = [ctx.sessions[sid] for sid in sids]
    for sess, g in zip(sessions, generator_states):
        sess.generator.set_state(g)
    first = sessions[0]
    select = sh.make_sharded_cohort_select(ctx.mesh, strategy=first.strategy_name, batch_size=k,
                                           **first.selection_options())
    batches = select([s.state for s in sessions], [s.generator for s in sessions],
                     first.pad_forbid, _group_params(sessions), n_real=ctx.n_real)
    return batches.tolist()


def _mesh_absorb(ctx, sid: str, idx: np.ndarray, y: np.ndarray) -> None:
    ctx.sessions[sid].absorb(idx, y)


def _mesh_cohort_update(ctx, sids: list, idx: np.ndarray, y: np.ndarray) -> None:
    """One sharded stacked update program of the sessions ``sids`` with
    (K, b) feedback blocks, written back into each session's own buffers
    once it and its checks have run."""
    states = [ctx.sessions[sid].state for sid in sids]
    dev = states[0].mu.device
    sh.make_sharded_cohort_update(ctx.mesh)(states, torch.as_tensor(idx, device=dev),
                                            torch.as_tensor(y, device=dev),
                                            torch.as_tensor(y != 0, device=dev))


def _mesh_ranking(ctx, sid: str, k: int) -> tuple:
    return ctx.sessions[sid].ranked(k)


def _mesh_labeled_rows(ctx, sid: str) -> torch.Tensor:
    return ctx.sessions[sid].labeled_rows()


def _mesh_refit(ctx, sid: str, values) -> None:
    ctx.sessions[sid].refit(values)


def _mesh_delete(ctx, sid: str) -> None:
    ctx.sessions.pop(sid, None)


def _mesh_snapshot(ctx, sid: str) -> gp_mod.GPState:
    full = sh.gather_session(ctx.mesh, ctx.sessions[sid].state)
    return dataclasses.replace(gp_mod.gp_session_copy(full, device="cpu"),
                               density=None if full.density is None else full.density.cpu())


def _mesh_restore(ctx, sid: str, blob: bytes) -> None:
    sess = ctx.sessions[sid]
    _restore_into(sess, sid, *sh.load_sharded_session(ctx.mesh, io.BytesIO(blob), sess.state))


_SESSION_RE = re.compile(
    r"^/sessions/([^/]+)(?:/(query|batch|feedback|ranking|learn|snapshot))?$"
)


class _Handler(BaseHTTPRequestHandler):
    service: RetrievalService  # bound by make_server

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _json(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _body(self) -> dict:
        n = int(self.headers.get("Content-Length") or 0)
        if not n:
            return {}
        return json.loads(self.rfile.read(n) or b"{}")

    def _dispatch(self, method: str) -> None:
        try:
            path, _, query = self.path.partition("?")
            qs = dict(p.split("=", 1) for p in query.split("&") if "=" in p)
            self._route(method, path, qs)
        except NotFound as e:
            self._json(404, {"error": str(e)})
        except (KeyError, ValueError, TypeError, json.JSONDecodeError) as e:
            # Missing fields, bad values, unknown strategies: the client's error.
            self._json(400, {"error": f"bad request: {e}"})
        except Exception as e:  # answer, and keep the server thread alive
            self._json(500, {"error": f"{type(e).__name__}: {e}"})

    def do_GET(self):  # noqa: N802 (stdlib API)
        self._dispatch("GET")

    def do_POST(self):  # noqa: N802
        self._dispatch("POST")

    def do_DELETE(self):  # noqa: N802
        self._dispatch("DELETE")

    def _route(self, method: str, path: str, qs: Dict[str, str]) -> None:
        svc = self.service
        if method == "GET" and path == "/healthz":
            return self._json(200, svc.health())
        if method == "POST" and path == "/sessions/restore":
            n = int(self.headers.get("Content-Length") or 0)
            return self._json(200, {"session_id": svc.restore(self.rfile.read(n))})
        if method == "POST" and path == "/batch_select":
            body = self._body()
            return self._json(200, {"batches": svc.next_batch_many(
                list(body.get("session_ids", [])), int(body.get("k", 4)))})
        if method == "POST" and path == "/batch_feedback":
            body = self._body()
            return self._json(200, {"sessions": svc.feedback_many(
                dict(body.get("feedback", {})))})
        if method == "POST" and path == "/sessions":
            body = self._body()
            sid = svc.create_session(
                strategy=body.get("strategy"), cap=body.get("cap"),
                label_prob=body.get("label_prob"), mistake_prob=body.get("mistake_prob"),
                length_scale=body.get("length_scale"), var=body.get("var"),
                noise=body.get("noise"), method_kwargs=body.get("method_kwargs"),
            )
            return self._json(200, {"session_id": sid})
        m = _SESSION_RE.match(path)
        if not m:
            return self._json(404, {"error": f"no route {method} {path}"})
        sid, action = m.group(1), m.group(2)
        if method == "DELETE" and action is None:
            svc.delete(sid)
            return self._json(200, {"deleted": sid})
        if method == "POST" and action == "query":
            svc.set_query(sid, self._body()["index"])
            return self._json(200, {"ok": True})
        if method == "GET" and action == "batch":
            return self._json(200, {"batch": svc.next_batch(sid, int(qs.get("k", 4)))})
        if method == "POST" and action == "feedback":
            return self._json(200, svc.feedback(sid, self._body().get("labels", {})))
        if method == "GET" and action == "ranking":
            return self._json(200, svc.ranking(sid, int(qs.get("k", 20))))
        if method == "GET" and action == "snapshot":
            blob = svc.snapshot(sid)
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)
            return None
        if method == "POST" and action == "learn":
            body = self._body()
            return self._json(200, svc.learn(
                sid, int(body.get("steps", 50)), float(body.get("prior_strength", 0.0)),
                float(body.get("noise_floor", 0.0)),
            ))
        return self._json(404, {"error": f"no route {method} {path}"})


class _Server(ThreadingHTTPServer):
    service: RetrievalService

    def shutdown(self) -> None:
        """Stop serving, then close the service (a mesh service's workers);
        a service without ``close`` is left as it is."""
        super().shutdown()
        getattr(self.service, "close", lambda: None)()


def make_server(service: RetrievalService, port: int = 0) -> ThreadingHTTPServer:
    """Bind a server on 127.0.0.1 (port 0: an ephemeral one); the caller
    runs ``serve_forever``.  Its ``shutdown`` closes the service."""
    handler = type("BoundHandler", (_Handler,), {"service": service})
    srv = _Server(("127.0.0.1", port), handler)
    srv.service = service
    return srv


def service_from_config(cfg, *, mesh_devices: int = 0, device=None) -> RetrievalService:
    """A service from an :class:`ExperimentConfig` (dataset, GP, user, method)
    on ``device`` (default ``cuda``); ``mesh_devices > 0`` shards the corpus
    over that many devices (the ``--mesh`` flag)."""
    from ital_tpu_torch.data import datasets as ds_mod
    from ital_tpu_torch.utils.config import apply_matmul_precision

    dev = resolve_device(device)
    apply_matmul_precision(cfg)
    ds = ds_mod.load_dataset(cfg.dataset, **cfg.dataset_kwargs)
    return RetrievalService(
        ds.x,
        length_scale=cfg.gp.length_scale, var=cfg.gp.var, noise=cfg.gp.noise,
        cap=cfg.cap, strategy=cfg.method,
        label_prob=cfg.user.label_prob, mistake_prob=cfg.user.mistake_prob,
        corpus_name=ds.name,
        method_kwargs={k: v for k, v in cfg.method_kwargs.items() if k != "tradeoff"},
        mesh_devices=mesh_devices, corpus_dtype=cfg.gp.corpus_dtype, device=dev,
    )


def main(argv=None) -> int:
    import argparse
    import signal

    from ital_tpu_torch.utils.config import load_config

    ap = argparse.ArgumentParser(prog="ital-tpu-torch-serve",
                                 description="ital_tpu_torch retrieval server")
    ap.add_argument("config", nargs="?", default=None)
    ap.add_argument("overrides", nargs="*")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="shard the corpus over N devices, one rank each (0: one device)")
    ap.add_argument("--device", default="cuda", help="torch device to serve on (default: cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error(f"--device {args.device}: no CUDA device is available "
                 f"(pass --device cpu to serve on the CPU)")
    cfg = load_config(args.config, tuple(args.overrides))
    svc = service_from_config(cfg, mesh_devices=args.mesh, device=device)
    srv = make_server(svc, args.port)
    mesh = f", mesh of {args.mesh}" if args.mesh else ""
    print(f"# serving {cfg.dataset} on http://127.0.0.1:{srv.server_address[1]} "
          f"({device}{mesh})", flush=True)
    # SIGTERM ends the server like ^C, so a mesh's workers are stopped.
    signal.signal(signal.SIGTERM, signal.default_int_handler)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        svc.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

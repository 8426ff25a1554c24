"""HTTP serving layer for interactive retrieval sessions (port of ``ital_tpu.serve``, one device).

A small stdlib-only HTTP front end over
:class:`ital_tpu_torch.models.session.ActiveRetrieval`.  One process owns the
card; the corpus is one device tensor shared by every session (features are
never copied per session), and on the card every RBF block of a request goes
through the hand-written kernel.

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
  generator, its own feedback bucket width, its own capacity error.  A
  compatible group (same strategy, capacity, options and density) selects
  with one stacked selection over the shared corpus
  (:func:`ital_tpu_torch.select.base.get_stacked_strategy`; ITAL's is
  :func:`ital_tpu_torch.select.ital.select_ital_stacked`), and the sessions
  of one (width, capacity) feedback group take one stacked GP update
  (:func:`ital_tpu_torch.models.gp.gp_update_stacked`), written back into
  each session's buffers under its lock.  Groups larger than the memory
  budget (``ITAL_TPU_COHORT_STATE_BYTES``, :meth:`RetrievalService.
  _max_cohort_sessions`) run as several stacked programs, with the same
  results.

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
``--device`` defaults to ``cuda`` and fails without a card.
"""

from __future__ import annotations

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
from ital_tpu_torch.runner import DENSITY_STRATEGIES
from ital_tpu_torch.select.base import filter_method_kwargs, get_stacked_strategy
from ital_tpu_torch.utils import checkpoint as ckpt

_MESH_UNPORTED = (
    "mesh-sharded serving is not ported to ital_tpu_torch yet: see ROADMAP.md, "
    "queue 1 item 2 (ShardedRetrieval and serve --mesh)"
)

# Peak device memory a stacked cohort program adds per session: COPIES of the
# session's (cap, N) f32 whitened buffer v (the stack and the corpus-wide
# temporaries, which grow with N) plus FIXED_BYTES that do not grow with N
# (the selection's MI scan over the session's pool).  From the rise of
# torch.cuda.max_memory_allocated over K = 8 sessions at the production
# settings (cap 64, pool 4096) on an H100 80GB HBM3 at 700 W (chip_smoke.py
# phases 8 and 9; PERF.md): a selection added 95.55 MiB a session at 25 000
# rows and 115.13 MiB at 100 000, which fit 1.07 copies + 89.0 MiB; an
# update 1.26 and 1.24 copies.  Rounded up.
SELECT_COPIES = 1.25
SELECT_FIXED_BYTES = 96 << 20
UPDATE_COPIES = 2
# The default of ITAL_TPU_COHORT_STATE_BYTES, the device memory a stacked
# program may take beyond the live sessions and the corpus: a tenth of the
# H100's 80 GB.  At cap 64 a selection then takes 79 sessions at a time at
# 25 000 rows and 20 at 1M rows, an update 671 and 16.
COHORT_STATE_BYTES = 8 << 30


def max_cohort_sessions(cap: int, n: int, copies: float, fixed_bytes: int = 0) -> int:
    """Largest session group one stacked program over an (n,)-row corpus
    takes: the budget (``ITAL_TPU_COHORT_STATE_BYTES``, default
    :data:`COHORT_STATE_BYTES`) over ``copies`` (cap, n) f32 buffers plus
    ``fixed_bytes`` a session (:data:`SELECT_COPIES` and
    :data:`SELECT_FIXED_BYTES`, :data:`UPDATE_COPIES`)."""
    budget = int(os.environ.get("ITAL_TPU_COHORT_STATE_BYTES", COHORT_STATE_BYTES))
    return max(1, int(budget // (copies * int(cap) * int(n) * 4 + fixed_bytes)))


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
        if mesh_devices:
            raise NotImplementedError(_MESH_UNPORTED)
        dev = resolve_device(device)
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
        # sid -> (ActiveRetrieval, its lock).
        self._sessions: Dict[str, tuple] = {}
        self._next = 0
        self._lock = threading.Lock()
        # The corpus density, built once per length scale (its only input)
        # and shared by every density-strategy session at that scale.
        self._density_by_ls: Dict[float, torch.Tensor] = {}

    def health(self) -> dict:
        return {"ok": True, "corpus": self.corpus_name, "n": self.n_real,
                "sessions": len(self._sessions), "mesh_devices": 0,
                "device": str(self.x.device)}

    def create_session(self, **overrides) -> str:
        """A new session over the shared corpus; ``overrides`` replace the
        service's defaults, and ``method_kwargs`` layer over its options
        (the session's constructor rejects names its strategy does not
        declare)."""
        mkw_over = overrides.pop("method_kwargs", None)
        cfg = {**self.defaults, **{k: v for k, v in overrides.items() if v is not None}}
        strategy = str(cfg["strategy"])
        sess = ActiveRetrieval(
            self.x,
            length_scale=float(cfg["length_scale"]), var=float(cfg["var"]),
            noise=float(cfg["noise"]), cap=int(cfg["cap"]), strategy=strategy,
            label_prob=float(cfg["label_prob"]), mistake_prob=float(cfg["mistake_prob"]),
            method_kwargs={**filter_method_kwargs(strategy, self.method_kwargs),
                           **(mkw_over or {})},
        )
        if strategy in DENSITY_STRATEGIES:
            # Built outside the registry lock, which guards only dict reads and
            # writes; racing creators may both build it, and the first insert
            # wins (the two are the same values).
            ls = float(cfg["length_scale"])
            with self._lock:
                dens = self._density_by_ls.get(ls)
            if dens is None:
                dens = gp_mod.corpus_density(sess.state)
                with self._lock:
                    dens = self._density_by_ls.setdefault(ls, dens)
            sess.state.density = dens
            # The cohort-compatibility key of the shared vector.
            sess._density_ls = ls
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

    def set_query(self, sid: str, index: int) -> None:
        sess, lock = self._entry(sid)
        with lock:
            sess.update_query(int(index))

    def next_batch(self, sid: str, k: int) -> list:
        sess, lock = self._entry(sid)
        with lock:
            return [int(i) for i in sess.fetch_unlabelled(int(k))]

    def _max_cohort_sessions(self, cap: int, copies: float, fixed_bytes: int = 0) -> int:
        """:func:`max_cohort_sessions` over this service's corpus."""
        return max_cohort_sessions(cap, self.x.shape[0], copies, fixed_bytes)

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
                return self._select_each_locked(entries, int(k))
            limit = self._max_cohort_sessions(sessions[0].state.cap, SELECT_COPIES,
                                              SELECT_FIXED_BYTES)
            out: Dict[str, list] = {}
            for i in range(0, len(entries), limit):
                out.update(self._select_cohort_locked(entries[i:i + limit], int(k)))
            return out
        finally:
            self._unlock_group(entries)

    @staticmethod
    def _select_each_locked(entries, k: int) -> Dict[str, list]:
        return {sid: [int(i) for i in s.fetch_unlabelled(k)] for sid, s, _ in entries}

    def _select_cohort_locked(self, entries, k: int) -> Dict[str, list]:
        """A compatible, locked group's selection: one stacked selection of
        the group's sessions (per user model, which the stack shares), each
        drawing from its own generator."""
        by_params: Dict[tuple, list] = {}
        for e in entries:
            by_params.setdefault(e[1].params_key, []).append(e)
        out: Dict[str, list] = {}
        for group in by_params.values():
            sessions = [s for _, s, _ in group]
            name = sessions[0].strategy_name
            select = get_stacked_strategy(name)
            batches = select(gp_mod.stack_states([s.state for s in sessions]), k,
                             [s.generator for s in sessions], sessions[0].params,
                             **filter_method_kwargs(name, sessions[0].method_kwargs))
            out.update({sid: [int(i) for i in row]
                        for (sid, _, _), row in zip(group, batches.cpu().numpy())})
        return out

    def feedback(self, sid: str, labels: Dict[str, int]) -> dict:
        sess, lock = self._entry(sid)
        with lock:
            sess.update(_parse_labels(labels))
            return {"labeled": int(sess.state.count)}

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
        hyperparameters.
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
                    groups.setdefault((len(idx), cap), []).append((s, idx, y))
            for (_, cap), group in groups.items():
                limit = self._max_cohort_sessions(cap, UPDATE_COPIES)
                for i in range(0, len(group), limit):
                    self._update_cohort_locked(group[i:i + limit])
            return {sid: out.get(sid, {"labeled": int(s.state.count)}) for sid, s, _ in entries}
        finally:
            self._unlock_group(entries)

    def _update_cohort_locked(self, group) -> None:
        """One stacked GP update of locked sessions ``(session, idx, y)`` with
        feedback blocks of one width, written back into each session's own
        buffers once the whole update has succeeded."""
        dev = self.x.device
        states = [s.state for s, _, _ in group]
        idx = torch.as_tensor(np.stack([i for _, i, _ in group]), device=dev)
        y = np.stack([y for _, _, y in group])
        st = gp_mod.stack_states(states)
        gp_mod.gp_update_stacked(st, idx, torch.as_tensor(y, device=dev),
                                 torch.as_tensor(y != 0, device=dev))
        gp_mod.unstack_into(st, states)

    def ranking(self, sid: str, k: int) -> dict:
        sess, lock = self._entry(sid)
        with lock:
            top = sess.top_k(int(k))
            scores = sess.scores()
        return {"top": [int(i) for i in top],
                "scores": [round(float(scores[i]), 6) for i in top]}

    def learn(self, sid: str, steps: int = 50, prior_strength: float = 0.0,
              noise_floor: float = 0.0) -> dict:
        if prior_strength < 0 or noise_floor < 0:
            raise ValueError("prior_strength/noise_floor must be >= 0")
        sess, lock = self._entry(sid)
        with lock:
            return sess.learn_hyperparams(
                steps=int(steps), prior_strength=float(prior_strength),
                noise_floor=float(noise_floor),
            )

    def delete(self, sid: str) -> None:
        with self._lock:
            self._sessions.pop(sid, None)

    # -- snapshot / restore (failover through utils.checkpoint) -------------

    def snapshot(self, sid: str) -> bytes:
        """A session (everything but the shared corpus) as npz bytes.

        The session's buffers are copied to the host under its lock, since
        updates write them in place; serialization runs outside every lock.
        """
        sess, lock = self._entry(sid)
        with lock:
            state = gp_mod.gp_session_copy(sess.state, device="cpu")
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
        """A new session from :meth:`snapshot` bytes over the same corpus.

        Capacity and strategy options come from the snapshot; strategy and
        user model from the service's defaults.
        """
        with np.load(io.BytesIO(blob)) as npz:
            cap = int(npz["state_idx"].shape[0])
        sid = self.create_session(cap=cap)
        sess, lock = self._entry(sid)
        with lock:
            state, extra = ckpt.load_session(io.BytesIO(blob), sess.state)
            sess.state = state
            q = int(extra["query"]) if "query" in extra else -1
            sess.query = None if q < 0 else q
            if "method_kwargs" in extra:
                # Replaced, not merged: the snapshot holds the merge that was
                # in force when it was taken.
                sess.method_kwargs = json.loads(str(extra["method_kwargs"]))
            if state.density is not None:
                # The restored density may come from another length scale
                # than this service's; a unique key keeps the session out of
                # cohort groups.
                sess._density_ls = ("restored", sid)
        return sid


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


def make_server(service: RetrievalService, port: int = 0) -> ThreadingHTTPServer:
    """Bind a server on 127.0.0.1 (port 0: an ephemeral one); the caller
    runs ``serve_forever``."""
    handler = type("BoundHandler", (_Handler,), {"service": service})
    return ThreadingHTTPServer(("127.0.0.1", port), handler)


def service_from_config(cfg, *, mesh_devices: int = 0, device=None) -> RetrievalService:
    """A service from an :class:`ExperimentConfig` (dataset, GP, user, method)
    on ``device`` (default ``cuda``)."""
    from ital_tpu_torch.data import datasets as ds_mod
    from ital_tpu_torch.utils.config import apply_matmul_precision

    if mesh_devices:
        raise NotImplementedError(_MESH_UNPORTED)
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
        corpus_dtype=cfg.gp.corpus_dtype, device=dev,
    )


def main(argv=None) -> int:
    import argparse

    from ital_tpu_torch.utils.config import load_config

    ap = argparse.ArgumentParser(prog="ital-tpu-torch-serve",
                                 description="ital_tpu_torch retrieval server")
    ap.add_argument("config", nargs="?", default=None)
    ap.add_argument("overrides", nargs="*")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="shard the corpus over N devices (not ported yet: raises)")
    ap.add_argument("--device", default="cuda", help="torch device to serve on (default: cuda)")
    args = ap.parse_args(argv)
    if args.mesh:
        raise NotImplementedError(_MESH_UNPORTED)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error(f"--device {args.device}: no CUDA device is available "
                 f"(pass --device cpu to serve on the CPU)")
    cfg = load_config(args.config, tuple(args.overrides))
    srv = make_server(service_from_config(cfg, device=device), args.port)
    print(f"# serving {cfg.dataset} on http://127.0.0.1:{srv.server_address[1]} "
          f"({device})", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

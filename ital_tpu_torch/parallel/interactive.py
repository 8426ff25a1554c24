"""Mesh-sharded interactive retrieval (port of ``ital_tpu.parallel.interactive``).

:class:`ShardedRetrieval` is :class:`ital_tpu_torch.models.session.ActiveRetrieval`
over a corpus sharded over a mesh: the same surface (``update_query``,
``fetch_unlabelled``, ``update``, ``scores``, ``top_k``, ``relevant_ids``,
``irrelevant_ids``, ``learn_hyperparams``), the same draws and the same
feedback buckets, with selection and updates running as the sharded
programs of :mod:`ital_tpu_torch.parallel.sharded`.  It is SPMD code: every
rank of the mesh holds the session over its own shard and makes the same
calls in the same order with the same arguments.

JAX ran the reference's mesh from one process.  Here each rank is a process:
:class:`MeshWorld` is the handle of rank 0, which runs in the calling process
(a mesh of one runs there alone) and starts the other ranks as worker
processes, one per device.  The workers loop on commands that rank 0
broadcasts, ``(fn, args)`` with ``fn`` a module-level function, and every
rank runs ``fn(ctx, *args)`` on its own :class:`MeshContext` (its corpus
shard and its sessions); rank 0 keeps its result.  Arguments carry what the
ranks must agree on: indices, labels, generator states.

A command that raises on any rank of a mesh of more than one stops the
mesh: a worker that raises writes its traceback and exits, so the pending
or next collective of rank 0 fails instead of waiting, and rank 0 raises
:class:`~ital_tpu_torch.parallel.launch.RankFailed` with that traceback;
every later command then fails at once.  Callers validate what they can
before a command (unknown sessions, capacities, options), so a stopped
mesh means a fault, not a bad request.  The one exception is a program's
check (``graphs.check_after``, a block that is not positive definite):
it reads values every rank holds alike, so every rank raises it at the
same point and no rank's session changes; the command then fails on rank 0
with that exception and the mesh goes on.

A session's calls run the mesh's programs (:mod:`ital_tpu_torch.graphs`),
found again by signature and mesh on every call; closing the mesh releases
them on every rank.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import shutil
import tempfile
import threading
import time
import traceback
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ital_tpu_torch import graphs
from ital_tpu_torch.models import gp as gp_mod
from ital_tpu_torch.models.hyperopt import fit_hyperparams
from ital_tpu_torch.models.session import check_method_kwargs, feedback_block
from ital_tpu_torch.parallel import sharded as sh
from ital_tpu_torch.parallel.launch import RankFailed, _first_failure
from ital_tpu_torch.parallel.mesh import Mesh, make_mesh
from ital_tpu_torch.select.base import StrategyParams, filter_method_kwargs
from ital_tpu_torch.utils.metrics import top_k_stable

# The options the sharded selection takes: ITAL's.  The baselines take
# theirs through StrategyParams (tradeoff), so any other option is an error
# rather than a silent difference from the single-device session.
_FACTORY_KEYS = frozenset({
    "n_qmc", "block", "pool_size", "subsample_size",
    "refine_top", "refine_n_qmc", "randomize_qmc",
})


def check_mesh_options(strategy: str, method_kwargs: dict) -> None:
    """:func:`~ital_tpu_torch.models.session.check_method_kwargs`, and only
    the options of :data:`_FACTORY_KEYS`."""
    check_method_kwargs(strategy, method_kwargs)
    unsupported = sorted(set(method_kwargs) - _FACTORY_KEYS)
    if unsupported:
        raise ValueError(
            f"method_kwargs {unsupported} are not supported on the mesh-sharded serving "
            f"path (supported: {sorted(_FACTORY_KEYS)})")


class ShardedRetrieval:
    """One rank's part of an interactive retrieval session over a corpus
    sharded over ``mesh``.

    ``x_local`` is this rank's shard of the corpus padded to ``n_pad`` rows
    (``sharded.pad_to_devices``), on the mesh's device; ``n_real`` rows are
    real, and pad rows are never selected or ranked.  Every rank constructs
    the session with the same arguments and calls its methods in the same
    order; the results are replicated.  Draws come from ``generator``, seeded
    alike on every rank, in the single-device session's order, so the
    batches are that session's.
    """

    def __init__(
        self,
        x_local: torch.Tensor,
        n_real: int,
        n_pad: int,
        mesh: Mesh,
        *,
        length_scale: float,
        var: float = 1.0,
        noise: float = 0.1,
        cap: int = 64,
        strategy: str = "ital",
        label_prob: float = 1.0,
        mistake_prob: float = 0.0,
        tradeoff: float = 0.5,
        seed: int = 0,
        method_kwargs: Optional[dict] = None,
    ):
        self.method_kwargs = dict(method_kwargs or {})
        check_mesh_options(strategy, self.method_kwargs)
        self.mesh = mesh
        self.n_real = int(n_real)
        self.device = x_local.device
        self.strategy_name = strategy
        self.state = gp_mod.gp_init(x_local, length_scale, var, noise, cap)
        self.params = StrategyParams.create(self.device, label_prob=label_prob,
                                            mistake_prob=mistake_prob, tradeoff=tradeoff)
        self.params_key = (float(label_prob), float(mistake_prob), float(tradeoff))
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.query: Optional[int] = None
        # The replicated (N,) pad mask: the one selection input the
        # single-device session lacks (its corpus is unpadded).
        self.pad_forbid = torch.arange(n_pad, device=self.device) >= self.n_real

    def update_query(self, query_idx: int) -> None:
        """Reset the session to a new query image (counted as a +1 label)."""
        self.query = int(query_idx)
        self.state = sh.make_sharded_set_query(self.mesh)(self.state, self.query)

    def selection_options(self) -> dict:
        """The options of this session's strategy (filtered on every call: a
        restored session's options replace ``method_kwargs``)."""
        return filter_method_kwargs(self.strategy_name, self.method_kwargs)

    def fetch_unlabelled(self, k: int) -> np.ndarray:
        """Next batch of k candidate indices (the sharded greedy selection)."""
        select = sh.make_sharded_select(self.mesh, strategy=self.strategy_name,
                                        batch_size=int(k), **self.selection_options())
        return select(self.state, self.generator, self.pad_forbid, self.params,
                      n_real=self.n_real).cpu().numpy()

    def feedback_block(self, feedback: Dict[int, int]) -> tuple[np.ndarray, np.ndarray]:
        """The block :meth:`update` absorbs (``models.session.feedback_block``)."""
        return feedback_block(self.state, feedback)

    def update(self, feedback: Dict[int, int]) -> None:
        """Apply one round of user feedback (the single-device bucketing and
        capacity check)."""
        if feedback:
            self.absorb(*self.feedback_block(feedback))

    def absorb(self, idx: np.ndarray, y: np.ndarray) -> None:
        """``gp_update`` of a feedback block (labels 0 where skipped) on the mesh."""
        dev = self.device
        self.state = sh.make_sharded_update(self.mesh)(
            self.state, torch.as_tensor(idx, device=dev), torch.as_tensor(y, device=dev),
            torch.as_tensor(y != 0, device=dev))

    def scores(self) -> np.ndarray:
        """Relevance scores (posterior mean) of the real corpus rows, gathered."""
        return sh.gather_mu(self.mesh, self.state.mu)[: self.n_real].cpu().numpy()

    def ranked(self, k: int, exclude_labeled: bool = True) -> tuple[np.ndarray, np.ndarray]:
        """The top ``k`` real rows by posterior mean and their means, as one
        program (the reference's ``_jit_rank``).

        Each rank takes a stable top-k of its real rows (labeled ones at
        -inf where excluded) and one gather of (key, index, mean) triples
        merges them: sorted by index, then stably by key, so ties go to the
        lowest index as ``utils.metrics.top_k_stable`` on the whole vector.
        A rank with fewer real rows than k fills its slots with entries that
        sort last; pad rows never rank.
        """
        st = self.state
        n_loc = st.x.shape[0]
        real = max(0, min(n_loc, self.n_real - self.mesh.rank * n_loc))
        k = min(int(k), self.n_real)
        idx, mu = sh._program(
            self.mesh, "sharded_rank", functools.partial(
                _rank_body, k=k, real=real, exclude_labeled=bool(exclude_labeled),
                n_pad=int(self.pad_forbid.shape[0])),
            {"count": st.count, "idx": st.idx, "valid": st.valid, "mu": st.mu}, {"x": st.x},
            static=(k, real, bool(exclude_labeled)))
        return idx.cpu().numpy(), mu.cpu().numpy()

    def top_k(self, k: int, exclude_labeled: bool = True) -> np.ndarray:
        """Top-k retrieval by posterior mean; ties go to the lower index."""
        return self.ranked(k, exclude_labeled)[0]

    @property
    def relevant_ids(self) -> np.ndarray:
        """Indices the user has labeled relevant (replicated buffers)."""
        st = self.state
        return st.idx[st.active & (st.y > 0)].cpu().numpy()

    @property
    def irrelevant_ids(self) -> np.ndarray:
        st = self.state
        return st.idx[st.active & (st.y < 0)].cpu().numpy()

    def labeled_rows(self) -> torch.Tensor:
        """The (cap, D) rows of the labeled slots, gathered (one sum), as one
        program."""
        return sh.labeled_rows(self.mesh, self.state)

    def refit(self, values) -> None:
        """Set the hyperparameters to ``values`` (length scale, variance,
        noise) and refit the posterior on the mesh (``gp_fit`` with the
        collective gather)."""
        dt, dev = self.state.mu.dtype, self.device
        ls, var, noise = (torch.tensor(float(v), dtype=dt, device=dev) for v in values)
        hyper = gp_mod.GPHyper(length_scale=ls, var=var, noise=noise)
        # The program refits the session's own buffers, with the new values.
        self.state = sh.make_sharded_fit(self.mesh)(dataclasses.replace(self.state, hyper=hyper))

    def fit_hyperparams(self, rows: torch.Tensor, **kwargs) -> tuple:
        """The re-learned (length scale, variance, noise) from the labeled
        ``rows`` (:meth:`labeled_rows`), as host floats; writes nothing."""
        st = self.state
        h = fit_hyperparams(rows, st.y, st.active, st.hyper, **kwargs)
        return float(h.length_scale), float(h.var), float(h.noise)

    def learn_hyperparams(self, *, steps: int = 50, lr: float = 0.05, learn_noise: bool = True,
                          prior_strength: float = 0.0,
                          noise_floor: float = 0.0) -> Dict[str, float]:
        """Type-II (or MAP type-II) re-learn and the sharded refit.

        The labeled rows are gathered (cap x D), the ascent runs on them as
        in the single-device session (through the kernel's gradient on the
        card), rank 0's values go to every rank, and the refit is the
        sharded ``gp_fit``.  Returns the new values.
        """
        vals = self.fit_hyperparams(self.labeled_rows(), steps=steps, lr=lr,
                                    learn_noise=learn_noise, prior_strength=prior_strength,
                                    noise_floor=noise_floor)
        if self.mesh.size > 1:
            box = [vals]
            dist.broadcast_object_list(box, src=0, group=self.mesh.group)
            vals = box[0]
        self.refit(vals)
        return dict(zip(("length_scale", "var", "noise"), vals))


def _rank_body(x, *, mesh, k, real, exclude_labeled, n_pad, count, idx, valid, mu) -> tuple:
    """:meth:`ShardedRetrieval.ranked` as a program's body: (k,) global
    indices and their means."""
    st = gp_mod.GPState(x=x, idx=idx, y=None, valid=valid, count=count, l=None, beta=None,
                        v=None, mu=mu, sig2=None, hyper=None)
    lo = mesh.rank * x.shape[0]
    key = mu
    if exclude_labeled:
        key = torch.where(sh.local_slot_mask(mesh, st, extra_forbid=torch.zeros(
            (), dtype=torch.bool, device=mu.device)), -torch.inf, key)
    vals, top = top_k_stable(key[:real], min(k, real))
    f64 = torch.float64
    trip = torch.full((k, 3), -torch.inf, dtype=f64, device=mu.device)
    trip[:, 1].fill_(float(n_pad))  # after every real index
    trip[: top.shape[0]] = torch.stack([vals.to(f64), (top + lo).to(f64), mu[top].to(f64)], -1)
    trip = sh.all_gather_cat(mesh, trip)
    trip = trip[torch.argsort(trip[:, 1], stable=True)]
    trip = trip[torch.argsort(trip[:, 0], descending=True, stable=True)][:k]
    return trip[:, 1].to(torch.int64), trip[:, 2]


# ---------------------------------------------------------------------------
# The mesh's ranks: rank 0 in the calling process, workers looping on commands
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MeshContext:
    """What one rank of a mesh service holds: its corpus shard (``x``, on
    its device), the padded and real row counts, the replicated pad mask,
    its part of every session, and the corpus densities it built (one per
    length scale, shared by every session at that scale)."""

    mesh: Mesh
    x: torch.Tensor
    n_real: int
    n_pad: int
    sessions: Dict[str, ShardedRetrieval] = dataclasses.field(default_factory=dict)
    density_by_ls: Dict[float, torch.Tensor] = dataclasses.field(default_factory=dict)

    @property
    def pad(self) -> torch.Tensor:
        return torch.arange(self.n_pad, device=self.x.device) >= self.n_real


def _context(mesh: Mesh, shard: np.ndarray, n_real: int, n_pad: int,
             corpus_dtype: str) -> MeshContext:
    x = torch.from_numpy(np.ascontiguousarray(shard, np.float32)).to(mesh.device)
    if corpus_dtype and corpus_dtype != "float32":
        x = x.to(getattr(torch, corpus_dtype))
    return MeshContext(mesh=mesh, x=x.contiguous(), n_real=n_real, n_pad=n_pad)


def _command(fn: Callable[..., Any], ctx: MeshContext, args: tuple) -> tuple:
    """``(fn(ctx, *args), None)``, or ``(None, exc)`` where a check raised
    ``exc`` (``graphs.uniform_failure``: every rank raises it alike, after
    the program's collectives and before its writes); anything else
    raises."""
    try:
        return fn(ctx, *args), None
    except Exception as exc:
        if not graphs.uniform_failure(exc):
            raise
        return None, exc


def _status(mesh: Mesh, failed: bool) -> None:
    """The collective that closes every command: it fails on rank 0 when a
    worker has stopped, and raises on any rank unless every rank's command
    either ran or failed the same check."""
    n = int(sh.psum(mesh, torch.full((1,), float(failed), device=mesh.device)).item())
    if n != (mesh.size if failed else 0):
        raise RuntimeError(f"{n} of {mesh.size} ranks failed a check: the ranks are out of step")


def _worker_main(rank: int, n_ranks: int, device_type: str, threads: int, work_dir: str,
                 shard: np.ndarray, n_real: int, n_pad: int, corpus_dtype: str) -> None:
    """A worker rank: join the mesh, then run rank 0's commands until it
    sends ``None``.  A command that raises writes its traceback to
    ``rank<r>.err`` and ends the process, which fails rank 0's collectives."""
    if device_type == "cpu":
        torch.set_num_threads(threads)
    try:
        mesh = make_mesh(n_ranks, device=device_type, rank=rank,
                         store_path=os.path.join(work_dir, "store"))
        ctx = _context(mesh, shard, n_real, n_pad, corpus_dtype)
        del shard
        while True:
            box = [None]
            dist.broadcast_object_list(box, src=0, group=mesh.group)
            if box[0] is None:
                break
            fn, args = box[0]
            _status(mesh, _command(fn, ctx, args)[1] is not None)
    except BaseException:
        with open(os.path.join(work_dir, f"rank{rank}.err"), "w") as fh:
            fh.write(f"{time.monotonic()!r}\n{traceback.format_exc()}")
        os._exit(1)
    mesh.close()


class MeshWorld:
    """Rank 0 of a mesh of ``n_ranks`` devices of ``device``'s type over the
    rows of ``x`` (N, D), padded to the mesh: each rank holds only its shard
    (``ctx.x`` here is rank 0's).

    A mesh of one runs in this process.  A larger one starts ``n_ranks - 1``
    worker processes (spawn), one per device, which receive their shards as
    they start.  :meth:`run` runs one command on every rank under one lock,
    since every rank must issue its collectives in the same order: callers
    serialize at the mesh.  :meth:`close` stops the workers and destroys the
    process group; a mesh holds the process's default group until then.
    """

    def __init__(self, n_ranks: int, x: np.ndarray, *, device, corpus_dtype: str = ""):
        dev_type = torch.device(device).type
        x_pad, n_real = sh.pad_to_devices(np.asarray(x, np.float32), n_ranks)
        n_pad = x_pad.shape[0]
        shard_n = n_pad // n_ranks
        self.lock = threading.Lock()
        self._procs: list = []
        self._work_dir: Optional[str] = None
        self._failure: Optional[str] = None
        if n_ranks > 1:
            self._work_dir = tempfile.mkdtemp(prefix="ital_serve_mesh_")
            spawn = torch.multiprocessing.get_context("spawn")
            threads = max(1, torch.get_num_threads() // n_ranks)
            for rank in range(1, n_ranks):
                shard = x_pad[rank * shard_n:(rank + 1) * shard_n]
                p = spawn.Process(target=_worker_main, daemon=True, args=(
                    rank, n_ranks, dev_type, threads, self._work_dir, shard, n_real, n_pad,
                    corpus_dtype))
                p.start()
                self._procs.append(p)
        try:
            mesh = make_mesh(n_ranks, device=dev_type, rank=0, store_path=None if n_ranks == 1
                             else os.path.join(self._work_dir, "store"))
        except BaseException:
            self._stop_workers(kill=True)
            raise
        self.ctx = _context(mesh, x_pad[:shard_n], n_real, n_pad, corpus_dtype)
        self.mesh = mesh

    def run(self, fn: Callable[..., Any], *args) -> Any:
        """``fn(ctx, *args)`` on every rank, in order with every other
        command; returns rank 0's value.  On a mesh of more than one, a
        failure on any rank stops the mesh and raises (``RankFailed`` with
        the traceback of the rank that failed first), but for a check that
        failed on every rank alike (a program's ``graphs.check_after``, which
        leaves every rank's session as it was): that raises its exception
        and the mesh goes on."""
        with self.lock:
            if self._failure is not None:
                raise RankFailed(f"the mesh has stopped: {self._failure}")
            if self.mesh.size == 1:
                return fn(self.ctx, *args)
            try:
                dist.broadcast_object_list([(fn, args)], src=0, group=self.mesh.group)
                out, failed = _command(fn, self.ctx, args)
                _status(self.mesh, failed is not None)
            except BaseException as exc:
                first = self._fail(exc)
                if first is not None:
                    raise RankFailed(first) from exc
                raise
            if failed is not None:
                raise failed
            return out

    def _fail(self, exc: BaseException) -> Optional[str]:
        """Stop the mesh after a failed command; returns the message naming
        the worker that failed first, if one did."""
        first = None
        for _ in range(50):  # a failing worker writes its traceback as it exits
            found = _first_failure(self._work_dir, self.mesh.size)
            if found is not None:
                first = f"rank {found[0]} of {self.mesh.size} failed first:\n{found[1]}"
                break
            if not any(p.is_alive() for p in self._procs):
                break
            time.sleep(0.1)
        self._failure = first or f"rank 0 failed: {type(exc).__name__}: {exc}"
        self._stop_workers(kill=True)
        self.mesh.close()
        return first

    def _stop_workers(self, *, kill: bool) -> None:
        for p in self._procs:
            if kill and p.is_alive():
                p.kill()
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        self._procs = []
        if self._work_dir is not None:
            shutil.rmtree(self._work_dir, ignore_errors=True)
            self._work_dir = None

    def close(self) -> None:
        """Stop the workers and destroy the process group (idempotent)."""
        with self.lock:
            if self._failure is None and self.mesh.size > 1 and self._procs:
                try:
                    dist.broadcast_object_list([None], src=0, group=self.mesh.group)
                except Exception:  # a worker already gone: stopped below
                    pass
            self._stop_workers(kill=False)
            self.mesh.close()
            if self._failure is None:
                self._failure = "the mesh was closed"

"""The port's mesh-sharded serving (``RetrievalService(mesh_devices=p)``,
``ital_tpu_torch.parallel.interactive``) against its single-device service
and against ``ital_tpu.serve``'s mesh service, on gloo meshes of CPU
processes (the tests of ``tests/test_serve_sharded.py``, and the mesh's own:
one rank in-process, ``close``, a failing worker).

One mesh service of 2 ranks serves most cases (:func:`pair`, beside a
single-device twin); the cases that need a mesh of their own run last and
close it first, since a process holds one mesh's process group at a time.
The corpus has 105 rows, so a mesh pads it (106 rows on 2 ranks, 108 on 4).
The user answers by class, and every session takes one label in each class
after its query (:data:`WARM`); ITAL sessions take label_prob 0.8 and
mistake_prob 0.1.  Both keep MI scores clear of ties.  Batches and rankings
are equal, scores within 2e-5 (the shards' blocks round apart from the whole
corpus'), learned values within 1e-6 relative.

Worker ranks import this module when a command defined here reaches them,
so it imports neither ``jax`` nor ``ital_tpu`` at its top.
"""

import io
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ital_tpu_torch.parallel.launch import RankFailed
from ital_tpu_torch.serve import RetrievalService, make_server

N_REAL = 105
BASE = dict(length_scale=2.5, noise=0.1, cap=24, strategy="ital", label_prob=0.8,
            mistake_prob=0.1, corpus_name="toy")
PRODUCTION = {"pool_size": 48, "n_qmc": 32, "refine_top": 8, "refine_n_qmc": 64}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _toy_corpus(n_per=35, d=6, classes=3, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(classes, d)) * 4
    x = np.concatenate([c + rng.normal(size=(n_per, d)) for c in centers])
    return x.astype(np.float32)


def _label(i):
    return 1 if i < 35 else -1


# Labels every session takes after its query, one in each class: on a cold
# posterior the far clusters' candidates tie in MI, and the shards' blocks,
# rounding apart from the whole corpus', would break the ties otherwise.
WARM = (12, 40, 75, 99)


def _start(svc, sid, query):
    svc.set_query(sid, query)
    svc.feedback(sid, {str(i): _label(i) for i in WARM})


_SHARED: dict = {}


def _shared():
    """(single-device service, mesh service of 2), started once and kept
    until a case that needs a mesh of its own closes them."""
    if not _SHARED:
        x = _toy_corpus()
        _SHARED["single"] = RetrievalService(x, **BASE, device="cpu")
        _SHARED["mesh"] = RetrievalService(x, **BASE, mesh_devices=2, device="cpu")
    return _SHARED["single"], _SHARED["mesh"]


def _close_shared():
    if _SHARED:
        _SHARED.pop("mesh").close()
        _SHARED.clear()
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def pair():
    yield _shared
    _close_shared()


def _drive(svc, rounds=3, k=3, query=5, **create):
    """One scripted session: its batches, its rankings and its final scores."""
    sid = svc.create_session(**create)
    _start(svc, sid, query)
    batches, rankings = [], []
    for _ in range(rounds):
        b = svc.next_batch(sid, k)
        batches.append(list(b))
        svc.feedback(sid, {str(i): _label(i) for i in b})
        rankings.append(svc.ranking(sid, 10))
    return sid, batches, rankings


def _assert_same_drive(one, mesh, **create):
    sid1, b1, r1 = _drive(one, **create)
    sid2, b2, r2 = _drive(mesh, **create)
    assert b1 == b2
    assert [r["top"] for r in r1] == [r["top"] for r in r2]
    np.testing.assert_allclose([r["scores"] for r in r1], [r["scores"] for r in r2], atol=2e-5)
    s1, s2 = one._entry(sid1)[0].scores(), mesh._world.run(_scores, sid2)
    assert s2.shape == (N_REAL,)
    np.testing.assert_allclose(s1, s2, atol=2e-5)
    return sid1, sid2


def _scores(ctx, sid):
    return ctx.sessions[sid].scores()


@pytest.mark.parametrize("strategy", ["ital", "uncertainty_sampling", "variance_sampling",
                                      "tcal"])
def test_mesh_service_matches_the_single_device_service(pair, strategy):
    one, mesh = pair()
    h = mesh.health()
    assert h["mesh_devices"] == 2 and h["n"] == one.health()["n"] == N_REAL
    assert mesh.x.shape[0] == 53  # rank 0 holds only its shard of the 106 padded rows
    _assert_same_drive(one, mesh, strategy=strategy)


def test_mesh_service_production_ital_config(pair):
    """The pool and the two-stage refinement, and a random subsample with
    randomized QMC drawn from the session's generator on every rank."""
    one, mesh = pair()
    _assert_same_drive(one, mesh, method_kwargs=PRODUCTION)
    _assert_same_drive(one, mesh, method_kwargs={"subsample_size": 40, "randomize_qmc": True,
                                                 "n_qmc": 16})


def test_mesh_service_never_serves_pad_rows(pair):
    _, mesh = pair()
    sid = mesh.create_session()
    _start(mesh, sid, 3)
    for _ in range(4):
        batch = mesh.next_batch(sid, 4)
        assert all(i < N_REAL for i in batch), batch
        mesh.feedback(sid, {str(i): _label(i) for i in batch})
    top = mesh.ranking(sid, 200)["top"]
    assert len(top) == N_REAL and sorted(top) == list(range(N_REAL))
    with pytest.raises(ValueError, match="outside the corpus"):
        mesh.set_query(sid, N_REAL)


def _cohort_rounds(svc, queries, mkw=None):
    sids = [svc.create_session(method_kwargs=mkw) for _ in queries]
    for sid, q in zip(sids, queries):
        _start(svc, sid, q)
    out = []
    for _ in range(2):
        batches = svc.next_batch_many(sids, 3)
        counts = svc.feedback_many({sid: {str(i): _label(i) for i in batches[sid]}
                                    for sid in sids})
        out.append(([batches[s] for s in sids], [counts[s]["labeled"] for s in sids]))
    return sids, out


def test_cohort_endpoints_match_the_single_device_service(pair, monkeypatch):
    one, mesh = pair()
    calls = []
    orig = RetrievalService._select_cohort_locked

    def spy(self, entries, k):
        calls.append(len(entries))
        return orig(self, entries, k)

    monkeypatch.setattr(RetrievalService, "_select_cohort_locked", spy)
    sids1, want = _cohort_rounds(one, (5, 6, 7))
    calls.clear()
    sids2, got = _cohort_rounds(mesh, (5, 6, 7))
    assert got == want and calls == [3, 3]
    np.testing.assert_allclose(mesh._world.run(_scores, sids2[2]),
                               one._entry(sids1[2])[0].scores(), atol=2e-5)


def test_cohort_select_matches_per_session_mesh_selects(pair):
    """On one mesh service: three sessions through ``/batch_select`` and
    three twins through ``GET /batch``, with the same histories (each trio's
    feedback through one cohort update)."""
    _, mesh = pair()
    cohort = [mesh.create_session() for _ in range(3)]
    twins = [mesh.create_session() for _ in range(3)]
    for j, (c, t) in enumerate(zip(cohort, twins)):
        _start(mesh, c, 5 + j)
        _start(mesh, t, 5 + j)
    for _ in range(2):
        got = mesh.next_batch_many(cohort, 3)
        alone = {t: mesh.next_batch(t, 3) for t in twins}
        assert [got[c] for c in cohort] == [alone[t] for t in twins]
        for group, picks in ((cohort, got), (twins, alone)):
            mesh.feedback_many({s: {str(i): _label(i) for i in picks[s]} for s in group})


def test_cohort_production_config_and_fallback(pair):
    """A group with the production options takes the cohort program; a group
    with one session on other options falls back to one selection each, with
    the same batches on both services."""
    one, mesh = pair()
    out = []
    for svc in (one, mesh):
        sids = [svc.create_session(method_kwargs=PRODUCTION) for _ in range(2)]
        sids.append(svc.create_session(method_kwargs={"n_qmc": 64}))
        for j, sid in enumerate(sids):
            _start(svc, sid, 4 + j)
        mixed = svc.next_batch_many(sids, 3)
        homog = svc.next_batch_many(sids[:2], 3)
        out.append(([mixed[s] for s in sids], [homog[s] for s in sids[:2]]))
    assert out[0] == out[1]


def test_cohort_feedback_keeps_capacity_errors_per_session(pair):
    one, mesh = pair()
    res = []
    for svc in (one, mesh):
        a, b = svc.create_session(cap=8), svc.create_session(cap=8)
        svc.set_query(a, 1)
        svc.set_query(b, 2)
        res.append(svc.feedback_many({a: {str(i): 1 for i in range(10, 18)},
                                      b: {"20": 1, "21": -1}}))
        res[-1] = {k: res[-1][s] for k, s in zip("ab", (a, b))}
    assert res[0] == res[1] and "error" in res[1]["a"] and res[1]["b"] == {"labeled": 5}


def test_mesh_snapshot_restore_roundtrip(pair):
    one, mesh = pair()
    for svc in (one, mesh):
        sid = svc.create_session(strategy="sud")
        _start(svc, sid, 7)
        batch = svc.next_batch(sid, 3)
        svc.feedback(sid, {str(i): _label(i) for i in batch})
        blob = svc.snapshot(sid)
        before = svc.ranking(sid, 10)["top"]
        sid2 = svc.restore(blob)
        assert svc.ranking(sid2, 10)["top"] == before
        nxt = svc.next_batch(sid2, 3)
        assert len(nxt) == 3 and all(i < N_REAL for i in nxt)
        with np.load(io.BytesIO(blob)) as z:
            if svc is mesh:
                assert z["state_v"].shape == (24, 106) and z["density"].shape == (106,)
                np.testing.assert_allclose(z["state_mu"][:N_REAL], single_mu, atol=2e-5)
                np.testing.assert_allclose(z["density"][:N_REAL], single_density, atol=1e-6)
                assert json.loads(str(z["extra_method_kwargs"])) == {}
            else:
                single_mu, single_density = z["state_mu"], z["density"]
    with pytest.raises(ValueError, match="does not fit this mesh service"):
        mesh.restore(one.snapshot(one.create_session()))


def test_mesh_snapshot_has_the_reference_mesh_services_keys_and_shapes(pair):
    """The same scripted session on ``ital_tpu.serve``'s mesh service of 2
    (the conftest's virtual devices): the same batches, and a snapshot with
    the same keys, shapes and dtypes over the same padded rows."""
    from ital_tpu import serve as jserve

    _, mesh = pair()
    ref = jserve.RetrievalService(_toy_corpus(), **BASE, mesh_devices=2)
    sid_j, b_j, r_j = _drive(ref)
    sid_t, b_t, r_t = _drive(mesh)
    assert b_j == b_t and [r["top"] for r in r_j] == [r["top"] for r in r_t]
    with np.load(io.BytesIO(ref.snapshot(sid_j))) as zj, \
            np.load(io.BytesIO(mesh.snapshot(sid_t))) as zt:
        assert set(zj.files) == set(zt.files)
        for f in zj.files:
            assert zj[f].shape == zt[f].shape and zj[f].dtype == zt[f].dtype, f
        np.testing.assert_array_equal(zj["state_idx"], zt["state_idx"])
        np.testing.assert_allclose(zj["state_mu"], zt["state_mu"], atol=1e-4)


def test_mesh_learn_endpoint_matches_the_single_device_service(pair):
    one, mesh = pair()
    out = []
    for svc in (one, mesh):
        sid = svc.create_session()
        _start(svc, sid, 2)
        batch = svc.next_batch(sid, 4)
        svc.feedback(sid, {str(i): _label(i) for i in batch})
        learned = svc.learn(sid, steps=5)
        out.append((learned, svc.next_batch(sid, 3), svc.ranking(sid, 10)["top"]))
    (l1, b1, t1), (l2, b2, t2) = out
    assert set(l2) == {"length_scale", "var", "noise"}
    assert all(np.isfinite(v) and v > 0 for v in l2.values()) and l2["length_scale"] != 2.5
    for f in l1:
        assert l2[f] == pytest.approx(l1[f], rel=1e-6)
    assert b1 == b2 and t1 == t2


def _session_surface(sess, feedback):
    """ActiveRetrieval's surface, run on a session (on a mesh, on every rank)."""
    sess.update(feedback)
    before = (sess.top_k(6).tolist(), sess.top_k(6, exclude_labeled=False).tolist(),
              sorted(sess.relevant_ids.tolist()), sorted(sess.irrelevant_ids.tolist()))
    return before, sess.learn_hyperparams(steps=5), sess.top_k(6).tolist()


def _mesh_session_surface(ctx, sid, feedback):
    return _session_surface(ctx.sessions[sid], feedback)


def test_sharded_retrieval_has_the_session_surface(pair):
    """``ShardedRetrieval``'s own ``update``, ``top_k``, ``relevant_ids`` /
    ``irrelevant_ids`` and ``learn_hyperparams`` (rank 0's fit broadcast),
    called on every rank, against ``ActiveRetrieval``'s."""
    one, mesh = pair()
    fb = {10: 1, 50: -1, 90: -1, 20: None}
    a, b = one.create_session(), mesh.create_session()
    _start(one, a, 6)
    _start(mesh, b, 6)
    want = _session_surface(one._entry(a)[0], fb)
    got = mesh._world.run(_mesh_session_surface, b, fb)
    assert got[0] == want[0] and got[2] == want[2]
    assert got[1] == pytest.approx(want[1], rel=1e-6)


def test_mesh_service_rejects_unsupported_kwargs(pair):
    _, mesh = pair()
    n = mesh.health()["sessions"]
    with pytest.raises(ValueError, match="not supported on the mesh"):
        mesh.create_session(method_kwargs={"qmc_shifts": 3})  # ITAL's, fed draws only
    with pytest.raises(ValueError, match="unknown method_kwargs"):
        mesh.create_session(method_kwargs={"pool_sizee": 3})
    assert mesh.health()["sessions"] == n


def test_mesh_service_over_http_and_shutdown_closes_it(pair):
    """One wire-level session against the mesh service; the server's shutdown
    then stops its worker and destroys its process group."""
    _, mesh = pair()
    workers = list(mesh._world._procs)
    srv = make_server(mesh, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"

    def req(path, method="GET", body=None):
        data = json.dumps(body).encode() if body is not None else None
        r = urllib.request.Request(url + path, data=data, method=method,
                                   headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(r, timeout=120) as resp:
            return json.loads(resp.read())

    try:
        h = req("/healthz")
        assert h["mesh_devices"] == 2 and h["n"] == N_REAL
        sid = req("/sessions", "POST", {})["session_id"]
        req(f"/sessions/{sid}/query", "POST", {"index": 5})
        b = req(f"/sessions/{sid}/batch?k=3")["batch"]
        assert len(b) == 3 and all(i < N_REAL for i in b)
        fb = req(f"/sessions/{sid}/feedback", "POST",
                 {"labels": {str(i): _label(i) for i in b}})
        assert fb["labeled"] >= 4
        top = req(f"/sessions/{sid}/ranking?k=10")["top"]
        assert len(top) == 10 and all(i < N_REAL for i in top)
        req(f"/sessions/{sid}", "DELETE")
        assert sid not in mesh._world.ctx.sessions
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)
    assert not dist.is_initialized() and not any(p.is_alive() for p in workers)
    _SHARED.clear()


# -- meshes of their own: the shared one is closed first --------------------------


def test_a_mesh_of_one_runs_in_process():
    _close_shared()
    x = _toy_corpus()
    one = RetrievalService(x, **BASE, device="cpu")
    mesh = RetrievalService(x, **BASE, mesh_devices=1, device="cpu")
    try:
        assert mesh._world._procs == [] and dist.get_world_size() == 1
        assert mesh.x.shape[0] == N_REAL  # one rank: no padding
        _assert_same_drive(one, mesh)
        _assert_same_drive(one, mesh, strategy="sud")
    finally:
        mesh.close()
    assert not dist.is_initialized()


def test_a_mesh_of_four_matches_the_single_device_service():
    _close_shared()
    x = _toy_corpus()
    one = RetrievalService(x, **BASE, device="cpu")
    mesh = RetrievalService(x, **BASE, mesh_devices=4, device="cpu")
    try:
        assert mesh.x.shape[0] == 27  # 108 padded rows over 4 ranks
        _assert_same_drive(one, mesh, method_kwargs=PRODUCTION)
        _, want = _cohort_rounds(one, (5, 45, 80, 9))
        _, got = _cohort_rounds(mesh, (5, 45, 80, 9))
        assert got == want
    finally:
        mesh.close()


def test_close_leaves_no_group_and_no_worker():
    _close_shared()
    x = _toy_corpus()
    mesh = RetrievalService(x, **BASE, mesh_devices=3, device="cpu")
    workers = list(mesh._world._procs)
    assert len(workers) == 2 and all(p.is_alive() for p in workers)
    mesh.close()
    mesh.close()  # idempotent
    assert not dist.is_initialized() and not any(p.is_alive() for p in workers)
    with pytest.raises(RankFailed, match="closed"):
        mesh.create_session()
    again = RetrievalService(x, **BASE, mesh_devices=2, device="cpu")  # one after another
    again.close()


def _fail_on_rank1(ctx):
    if ctx.mesh.rank == 1:
        raise RuntimeError("rank 1 failed on purpose")
    return "rank 0 is fine"


def _fail_on_rank1_in_a_collective(ctx):
    if ctx.mesh.rank == 1:
        raise RuntimeError("rank 1 failed before the sum on purpose")
    dist.all_reduce(torch.ones(1))  # would wait for rank 1 forever


@pytest.mark.parametrize("command", [_fail_on_rank1, _fail_on_rank1_in_a_collective])
def test_a_failing_worker_fails_the_request_with_its_traceback(command):
    _close_shared()
    mesh = RetrievalService(_toy_corpus(), **BASE, mesh_devices=2, device="cpu")
    try:
        sid = mesh.create_session()
        with pytest.raises(RankFailed, match="(?s)rank 1 of 2 failed first.*on purpose"):
            mesh._world.run(command)
        with pytest.raises(RankFailed, match="the mesh has stopped"):
            mesh.next_batch(sid, 2)
        assert not any(p.is_alive() for p in mesh._world._procs)
    finally:
        mesh.close()
    assert not dist.is_initialized()

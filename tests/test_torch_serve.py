"""The port's serving layer (``ital_tpu_torch.serve``) on the CPU, against ``ital_tpu.serve``.

The single-device tests of ``tests/test_serve.py``, run against the port's
service; one request script sent to both packages' services; snapshots
restored across packages; a snapshot taken under concurrent feedback; and
the entry points' device and mesh rules.  Scores compare to 1e-4 (f32
posteriors updated in other orders), learned values to 1e-4 relative.
"""

import io
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from ital_tpu import serve as jserve
from ital_tpu_torch import serve
from ital_tpu_torch.models import hyperopt
from ital_tpu_torch.models.gp import GPHyper
from ital_tpu_torch.select.ital import candidate_pool_indices
from ital_tpu_torch.serve import RetrievalService, make_server
from ital_tpu_torch.utils import config as tconfig

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _corpus(seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(3, 6)) * 4
    return np.concatenate([c + rng.normal(size=(40, 6)) for c in centers]).astype(np.float32)


def _serve(svc):
    srv = make_server(svc, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, t, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def server():
    svc = RetrievalService(_corpus(), length_scale=2.5, noise=0.1, cap=32, strategy="ital",
                           label_prob=1.0, mistake_prob=0.0, corpus_name="toy3x40",
                           device="cpu")
    srv, t, url = _serve(svc)
    yield url
    srv.shutdown()
    srv.server_close()
    t.join(timeout=30)


def _req(url, method="GET", body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _make(server, q, body=None):
    _, r = _req(f"{server}/sessions", "POST", body or {})
    sid = r["session_id"]
    _req(f"{server}/sessions/{sid}/query", "POST", {"index": q})
    return sid


def _spy_cohorts(svc):
    """Record each compatible group that reaches the cohort path."""
    calls = []
    orig = svc._select_cohort_locked

    def spy(entries, k):
        calls.append(tuple(sorted(sid for sid, _, _ in entries)))
        return orig(entries, k)

    svc._select_cohort_locked = spy
    return calls


def test_full_session_over_http(server):
    code, h = _req(f"{server}/healthz")
    assert code == 200 and h["ok"] and h["n"] == 120 and h["device"] == "cpu"
    code, r = _req(f"{server}/sessions", "POST", {})
    assert code == 200
    sid = r["session_id"]
    code, _ = _req(f"{server}/sessions/{sid}/query", "POST", {"index": 5})
    assert code == 200
    for _ in range(2):
        code, b = _req(f"{server}/sessions/{sid}/batch?k=3")
        assert code == 200 and len(b["batch"]) == 3
        labels = {str(i): (1 if i < 40 else -1) for i in b["batch"]}
        code, fb = _req(f"{server}/sessions/{sid}/feedback", "POST", {"labels": labels})
        assert code == 200 and fb["labeled"] >= 4
    code, rk = _req(f"{server}/sessions/{sid}/ranking?k=10")
    assert code == 200
    assert sum(1 for i in rk["top"] if i < 40) >= 8, rk  # the query's class dominates
    code, learned = _req(f"{server}/sessions/{sid}/learn", "POST", {"steps": 20})
    assert code == 200 and learned["length_scale"] > 0
    code, learned = _req(f"{server}/sessions/{sid}/learn", "POST",
                         {"steps": 20, "prior_strength": 1.0, "noise_floor": 0.07})
    assert code == 200 and learned["noise"] >= 0.07 * (1 - 1e-5), learned
    code, err = _req(f"{server}/sessions/{sid}/learn", "POST",
                     {"steps": 5, "prior_strength": -1.0})
    assert code == 400 and "prior_strength" in err["error"]
    code, _ = _req(f"{server}/sessions/{sid}", "DELETE")
    assert code == 200
    code, err = _req(f"{server}/sessions/{sid}/ranking?k=5")
    assert code == 404 and "no such session" in err["error"]


def test_session_overrides_and_errors(server):
    code, r = _req(f"{server}/sessions", "POST", {"strategy": "uncertainty_sampling", "cap": 16})
    assert code == 200
    sid = r["session_id"]
    _req(f"{server}/sessions/{sid}/query", "POST", {"index": 50})
    code, b = _req(f"{server}/sessions/{sid}/batch?k=2")
    assert code == 200 and len(b["batch"]) == 2
    assert _req(f"{server}/nope")[0] == 404
    assert _req(f"{server}/sessions/does-not-exist/batch?k=2")[0] == 404
    code, err = _req(f"{server}/sessions", "POST", {"strategy": "no_such_strategy"})
    assert code == 400 and "unknown strategy" in err["error"]


def test_concurrent_clients(server):
    """Two client threads drive independent sessions at once; every
    response stays consistent."""
    errors = []

    def client(query, lo, hi):
        try:
            sid = _make(server, query)
            for _ in range(2):
                code, b = _req(f"{server}/sessions/{sid}/batch?k=2")
                assert code == 200 and len(b["batch"]) == 2
                _req(f"{server}/sessions/{sid}/feedback", "POST",
                     {"labels": {str(i): (1 if lo <= i < hi else -1) for i in b["batch"]}})
            code, rk = _req(f"{server}/sessions/{sid}/ranking?k=5")
            assert code == 200 and len(rk["top"]) == 5
        except Exception as e:  # surfaced to the main thread below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(5, 0, 40)),
               threading.Thread(target=client, args=(45, 40, 80))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors


def test_snapshot_restore_over_http(server):
    """Failover: snapshot mid-session, delete, restore from the bytes: the
    ranking is the same and the session goes on."""
    sid = _make(server, 5)
    _, b = _req(f"{server}/sessions/{sid}/batch?k=3")
    _req(f"{server}/sessions/{sid}/feedback", "POST",
         {"labels": {str(i): (1 if i < 40 else -1) for i in b["batch"]}})
    _, before = _req(f"{server}/sessions/{sid}/ranking?k=10")
    with urllib.request.urlopen(f"{server}/sessions/{sid}/snapshot") as resp:
        blob = resp.read()
    assert resp.headers["Content-Type"] == "application/octet-stream"
    _req(f"{server}/sessions/{sid}", "DELETE")
    req = urllib.request.Request(f"{server}/sessions/restore", data=blob, method="POST")
    with urllib.request.urlopen(req) as resp2:
        sid2 = json.loads(resp2.read())["session_id"]
    _, after = _req(f"{server}/sessions/{sid2}/ranking?k=10")
    assert after == before
    code, b2 = _req(f"{server}/sessions/{sid2}/batch?k=2")
    assert code == 200 and len(b2["batch"]) == 2


def test_batch_select_cohort_matches_individual(server):
    """POST /batch_select gives the batches of per-session GET /batch."""
    sids = []
    for q in (3, 47, 85):
        sid = _make(server, q)
        _req(f"{server}/sessions/{sid}/feedback", "POST",
             {"labels": {str((q + 11) % 120): 1, str((q + 31) % 120): 1,
                         str((q + 60) % 120): -1, str((q + 90) % 120): -1}})
        sids.append(sid)
    singles = {}
    for sid in sids:
        code, r = _req(f"{server}/sessions/{sid}/batch?k=3")
        assert code == 200
        singles[sid] = r["batch"]
    code, r = _req(f"{server}/batch_select", "POST", {"session_ids": sids, "k": 3})
    assert code == 200 and r["batches"] == singles
    code, _ = _req(f"{server}/batch_select", "POST", {"session_ids": ["nope"], "k": 2})
    assert code == 404


def test_batch_select_mixed_capacity_falls_back(server):
    s1 = _make(server, 7)
    s2 = _make(server, 90, {"cap": 16})
    code, r = _req(f"{server}/batch_select", "POST", {"session_ids": [s1, s2], "k": 2})
    assert code == 200 and set(r["batches"]) == {s1, s2}
    assert all(len(b) == 2 for b in r["batches"].values())


def test_batch_feedback_cohort_matches_individual(server):
    """POST /batch_feedback leaves the posterior of per-session POST /feedback."""
    queries = (3, 47, 85)
    batched = [_make(server, q) for q in queries]
    singles = [_make(server, q) for q in queries]
    labels = [{"11": 1, "55": -1, "99": 1}, {"20": 1},
              {"70": -1, "90": 1, "100": 0, "30": 1, "31": -1}]
    code, r = _req(f"{server}/batch_feedback", "POST", {"feedback": dict(zip(batched, labels))})
    assert code == 200
    assert all(r["sessions"][sid]["labeled"] >= 2 for sid in batched)
    for sid, lab in zip(singles, labels):
        _req(f"{server}/sessions/{sid}/feedback", "POST", {"labels": lab})
    for sb, ss in zip(batched, singles):
        _, rb = _req(f"{server}/sessions/{sb}/ranking?k=15")
        _, rs = _req(f"{server}/sessions/{ss}/ranking?k=15")
        assert rb["top"] == rs["top"]
        np.testing.assert_allclose(rb["scores"], rs["scores"], atol=1e-4)


def test_batch_feedback_mixed_capacity_falls_back(server):
    s1 = _make(server, 7)
    s2 = _make(server, 90, {"cap": 16})
    code, r = _req(f"{server}/batch_feedback", "POST",
                   {"feedback": {s1: {"11": 1}, s2: {"95": 1}}})
    assert code == 200
    assert r["sessions"][s1]["labeled"] >= 2 and r["sessions"][s2]["labeled"] >= 2


def test_batch_select_density_sessions_batch():
    """Density sessions share one density vector (built once per length
    scale), so a group of them is compatible and takes the cohort path,
    with the batches of individual selection."""
    svc = RetrievalService(_corpus(), length_scale=2.5, noise=0.1, cap=32, strategy="sud",
                           device="cpu")
    sids = [svc.create_session() for _ in range(2)]
    for sid, q in zip(sids, (3, 47)):
        svc.set_query(sid, q)
        svc.feedback(sid, {str((q + 11) % 120): 1, str((q + 60) % 120): -1})
    states = [svc._entry(sid)[0].state for sid in sids]
    assert states[0].density is not None and states[0].density is states[1].density
    singles = {sid: svc.next_batch(sid, 3) for sid in sids}
    calls = _spy_cohorts(svc)
    assert svc.next_batch_many(sids, 3) == singles
    assert calls == [tuple(sorted(sids))]


@pytest.mark.parametrize("strategy,mkw", [
    ("ital", {"n_qmc": 32, "pool_size": 40, "refine_top": 8, "refine_n_qmc": 64}),
    ("tcal", {}), ("random", {})])
def test_batch_select_mixed_user_models_is_one_program(strategy, mkw, monkeypatch):
    """Sessions with three user models form one compatible group: one
    stacked selection program, whose batches are the K ``GET /batch``
    batches of twins with the same histories and seeds."""
    from ital_tpu_torch import graphs

    svc = RetrievalService(_corpus(2), length_scale=2.5, noise=0.1, cap=32, strategy=strategy,
                           method_kwargs=mkw, device="cpu")
    srv, t, url = _serve(svc)
    users = [{"label_prob": 0.9, "mistake_prob": 0.05}, {"label_prob": 0.7},
             {"label_prob": 1.0, "mistake_prob": 0.2}]
    try:
        cohort, twins = [], []
        for q, user in zip((3, 47, 85), users):
            for out in (cohort, twins):
                sid = _make(url, q, user)
                _req(f"{url}/sessions/{sid}/feedback", "POST",
                     {"labels": {str((q + 11) % 120): 1, str((q + 60) % 120): -1}})
                out.append(sid)
        calls = []
        run = graphs.run
        monkeypatch.setattr(graphs, "run", lambda name, *a, **kw: calls.append(name) or run(
            name, *a, **kw))
        code, r = _req(f"{url}/batch_select", "POST", {"session_ids": cohort, "k": 3})
        assert code == 200 and calls == [f"select_{strategy}_stacked"]
        for a, b in zip(cohort, twins):
            code, single = _req(f"{url}/sessions/{b}/batch?k=3")
            assert code == 200 and r["batches"][a] == single["batch"]
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)


def test_batch_select_chunks_by_each_strategys_budget(monkeypatch):
    """A group is chunked by its strategy's own ``SELECT_BUDGET`` entry: at
    a budget of 3.75 (cap, N) copies EMOC's 15.25 copies a session take one
    session a program and topscoring's 1.25 three; the batches are the
    per-session ones either way."""
    svc = RetrievalService(_corpus(3), length_scale=2.5, noise=0.1, cap=32, device="cpu")
    per = 32 * 120 * 4  # one (cap, N) f32 buffer
    monkeypatch.setenv("ITAL_TPU_COHORT_STATE_BYTES", str(int(3.75 * per)))
    for strategy, chunks in (("emoc", 3), ("topscoring", 1)):
        sids = []
        for q in (3, 47, 85):
            sids.append(svc.create_session(strategy=strategy))
            svc.set_query(sids[-1], q)
            svc.feedback(sids[-1], {str((q + 11) % 120): 1, str((q + 60) % 120): -1})
        singles = {sid: svc.next_batch(sid, 2) for sid in sids}
        calls = _spy_cohorts(svc)
        assert svc.next_batch_many(sids, 2) == singles
        assert len(calls) == chunks
        del svc._select_cohort_locked  # the spy


def test_batch_feedback_empty_labels_is_noop(server):
    """An empty label dict in a cohort changes nothing and burns no slots."""
    s_empty, s_a, s_b = _make(server, 3), _make(server, 47), _make(server, 85)
    code, r = _req(f"{server}/batch_feedback", "POST",
                   {"feedback": {s_empty: {}, s_a: {"50": 1, "60": -1}, s_b: {"90": 1}}})
    assert code == 200
    assert r["sessions"][s_empty]["labeled"] == 1
    # "labeled" counts the bucket's inert pad slots: query + 4.
    assert r["sessions"][s_a]["labeled"] == 5 and r["sessions"][s_b]["labeled"] == 5
    for _ in range(3):
        code, r = _req(f"{server}/batch_feedback", "POST", {"feedback": {s_empty: {}}})
        assert code == 200 and r["sessions"][s_empty]["labeled"] == 1


def test_batch_feedback_per_session_widths_match_individual(server):
    """Each session pads to its own bucket width, as POST /feedback does."""
    s_small, s_big = _make(server, 3), _make(server, 47)
    s_small_ref, s_big_ref = _make(server, 3), _make(server, 47)
    _, r1 = _req(f"{server}/sessions/{s_small_ref}/feedback", "POST", {"labels": {"50": 1}})
    _, r2 = _req(f"{server}/sessions/{s_big_ref}/feedback", "POST",
                 {"labels": {str(i): 1 for i in (60, 61, 62, 63, 64)}})
    code, r = _req(f"{server}/batch_feedback", "POST",
                   {"feedback": {s_small: {"50": 1},
                                 s_big: {str(i): 1 for i in (60, 61, 62, 63, 64)}}})
    assert code == 200
    assert r["sessions"][s_small] == r1 == {"labeled": 5}
    assert r["sessions"][s_big] == r2 == {"labeled": 9}


def test_batch_feedback_capacity_error_is_per_session(server):
    """Overflowing labels give that session an error entry; the rest apply."""
    s_full, s_ok = _make(server, 3), _make(server, 47)
    for j in range(7):  # 1 + 7 x 4 = 29 of the 32 slots
        _, rr = _req(f"{server}/sessions/{s_full}/feedback", "POST",
                     {"labels": {str(10 + j): 1}})
    assert rr["labeled"] == 29
    code, r = _req(f"{server}/batch_feedback", "POST",
                   {"feedback": {s_full: {str(i): 1 for i in range(90, 99)}, s_ok: {"50": 1}}})
    assert code == 200
    assert "capacity" in r["sessions"][s_full]["error"]
    assert r["sessions"][s_ok]["labeled"] == 5


def test_batch_feedback_malformed_input_is_atomic(server):
    """A malformed label anywhere rejects the whole request; nothing applies."""
    s_a, s_b = _make(server, 3), _make(server, 47)
    code, _ = _req(f"{server}/batch_feedback", "POST",
                   {"feedback": {s_a: {"50": 1}, s_b: {"not-an-index": 1}}})
    assert code == 400
    _, r = _req(f"{server}/batch_feedback", "POST", {"feedback": {s_a: {}}})
    assert r["sessions"][s_a]["labeled"] == 1
    code, _ = _req(f"{server}/batch_feedback", "POST", {"feedback": {"nope": {"1": 1}}})
    assert code == 404


def test_restored_density_session_excluded_from_cohort():
    """A restored density session may carry another length scale's vector,
    so it never joins a cohort; the batches still equal individual ones."""
    svc = RetrievalService(_corpus(1), length_scale=2.5, noise=0.1, cap=32, strategy="sud",
                           device="cpu")
    s1 = svc.create_session()
    svc.set_query(s1, 3)
    svc.feedback(s1, {"14": 1, "63": -1})
    s_restored = svc.restore(svc.snapshot(s1))
    s2 = svc.create_session()
    svc.set_query(s2, 47)
    svc.feedback(s2, {"58": 1, "107": -1})
    singles = {sid: svc.next_batch(sid, 3) for sid in (s_restored, s2)}
    calls = _spy_cohorts(svc)
    assert svc.next_batch_many([s_restored, s2], 3) == singles
    assert calls == []


def test_service_method_kwargs_reach_selection():
    """Service-level [METHOD] options reach every session's selection, the
    cohort path too; a strategy that does not declare them drops them."""
    svc = RetrievalService(
        _corpus(2), length_scale=2.5, noise=0.1, cap=32, strategy="ital",
        label_prob=0.9, mistake_prob=0.05, device="cpu",
        method_kwargs={"n_qmc": 32, "pool_size": 20, "refine_top": 8, "refine_n_qmc": 64,
                       "randomize_qmc": True},
    )
    sids = []
    for q in (3, 47):
        sid = svc.create_session()
        svc.set_query(sid, q)
        svc.feedback(sid, {"14": 1, "63": -1})
        sids.append(sid)
    singles = {sid: svc.next_batch(sid, 3) for sid in sids}
    # Rewind the generators so the cohort draws the same shifts.
    for sid in sids:
        svc._entry(sid)[0].generator.manual_seed(0)
    a = {sid: svc.next_batch(sid, 3) for sid in sids}
    for sid in sids:
        svc._entry(sid)[0].generator.manual_seed(0)
    calls = _spy_cohorts(svc)
    assert svc.next_batch_many(sids, 3) == a and len(calls) == 1
    for sid in sids:
        s, _ = svc._entry(sid)
        pool, _ = candidate_pool_indices(s.state, s.state.mu, 20)
        assert set(singles[sid]) <= set(pool.tolist())
    sid_r = svc.create_session(strategy="random")
    svc.set_query(sid_r, 3)
    assert len(svc.next_batch(sid_r, 3)) == 3


def test_per_session_method_kwargs():
    """Per-session options layer over the service's; only same-option groups
    take the cohort path; a snapshot keeps the session's effective options
    on a service with other defaults."""
    x = _corpus(5)
    svc = RetrievalService(x, length_scale=2.5, noise=0.1, cap=32, strategy="ital",
                           label_prob=0.9, mistake_prob=0.05, method_kwargs={"n_qmc": 32},
                           device="cpu")
    s_default = svc.create_session()
    s_pool = svc.create_session(method_kwargs={"pool_size": 16})
    s_pool2 = svc.create_session(method_kwargs={"pool_size": 16})
    for sid, q in ((s_default, 3), (s_pool, 47), (s_pool2, 47)):
        svc.set_query(sid, q)
        svc.feedback(sid, {"14": 1, "63": -1})
    sess_p, _ = svc._entry(s_pool)
    assert sess_p.method_kwargs == {"n_qmc": 32, "pool_size": 16}
    picks = svc.next_batch(s_pool, 3)
    pool, _ = candidate_pool_indices(sess_p.state, sess_p.state.mu, 16)
    assert set(picks) <= set(pool.tolist())
    calls = _spy_cohorts(svc)
    svc.next_batch_many([s_default, s_pool], 3)
    assert calls == []
    singles = {sid: svc.next_batch(sid, 3) for sid in (s_pool, s_pool2)}
    grouped = svc.next_batch_many([s_pool, s_pool2], 3)
    assert grouped == singles and calls == [tuple(sorted((s_pool, s_pool2)))]
    svc2 = RetrievalService(x, length_scale=2.5, noise=0.1, cap=32, strategy="ital",
                            label_prob=0.9, mistake_prob=0.05, method_kwargs={"n_qmc": 128},
                            device="cpu")
    s_restored = svc2.restore(svc.snapshot(s_pool))
    sess_r, _ = svc2._entry(s_restored)
    assert sess_r.method_kwargs == {"n_qmc": 32, "pool_size": 16}
    assert svc2.next_batch(s_restored, 3) == svc.next_batch(s_pool, 3)


def test_http_session_method_kwargs(server):
    sid = _make(server, 5, {"method_kwargs": {"n_qmc": 32, "pool_size": 12}})
    code, b = _req(f"{server}/sessions/{sid}/batch?k=3")
    assert code == 200 and len(b["batch"]) == 3
    assert _req(f"{server}/sessions/{sid}", "DELETE")[0] == 200


@pytest.mark.parametrize("mkw", [{"subsample_size": 30, "pool_size": 0},
                                 {"randomize_qmc": True}, {"subsample_size": 30,
                                                           "randomize_qmc": True}])
def test_http_random_modes(server, mkw):
    """Per-session subsample_size / randomize_qmc run over HTTP and draw from
    the session's generator: a twin session repeats the batches."""
    a, b = _make(server, 5, {"method_kwargs": mkw}), _make(server, 5, {"method_kwargs": mkw})
    for _ in range(2):
        _, ra = _req(f"{server}/sessions/{a}/batch?k=3")
        _, rb = _req(f"{server}/sessions/{b}/batch?k=3")
        assert ra == rb and len(set(ra["batch"])) == 3 and 5 not in ra["batch"]
        lab = {str(i): (1 if i < 40 else -1) for i in ra["batch"]}
        for sid in (a, b):
            _req(f"{server}/sessions/{sid}/feedback", "POST", {"labels": lab})


def test_http_session_method_kwargs_non_scalar_rejected(server):
    code, r = _req(f"{server}/sessions", "POST", {"method_kwargs": {"pool_size": [16, 32]}})
    assert code == 400 and "scalar" in r["error"]


def test_http_session_method_kwargs_unknown_rejected(server):
    code, r = _req(f"{server}/sessions", "POST", {"method_kwargs": {"pool_siez": 12}})
    assert code == 400 and "pool_siez" in r["error"]


def test_batch_select_duplicate_ids_no_deadlock(server):
    """Duplicate ids in a group must not take one session's lock twice."""
    sid = _make(server, 12)
    code, r = _req(f"{server}/batch_select", "POST", {"session_ids": [sid, sid], "k": 2})
    assert code == 200 and len(r["batches"][sid]) == 2
    assert _req(f"{server}/sessions/{sid}/batch?k=2")[0] == 200


def test_large_cohort_matches_twins(server):
    """A five-session cohort round (select, then feedback) leaves each
    session where its twin's individual requests leave it."""
    def make(q):
        sid = _make(server, q)
        _req(f"{server}/sessions/{sid}/feedback", "POST",
             {"labels": {str((q + 13) % 120): 1, str((q + 41) % 120): 1,
                         str((q + 67) % 120): -1, str((q + 95) % 120): -1}})
        return sid

    queries = (2, 29, 51, 76, 103)
    cohort = [make(q) for q in queries]
    twins = [make(q) for q in queries]
    code, r = _req(f"{server}/batch_select", "POST", {"session_ids": cohort, "k": 3})
    assert code == 200
    for sc, st in zip(cohort, twins):
        assert r["batches"][sc] == _req(f"{server}/sessions/{st}/batch?k=3")[1]["batch"]
    labels = [{str((q + 7) % 120): 1, str((q + 88) % 120): -1} for q in queries]
    code, r = _req(f"{server}/batch_feedback", "POST", {"feedback": dict(zip(cohort, labels))})
    assert code == 200
    for sc, st, lab in zip(cohort, twins, labels):
        assert r["sessions"][sc] == _req(f"{server}/sessions/{st}/feedback", "POST",
                                         {"labels": lab})[1]
        _, rc = _req(f"{server}/sessions/{sc}/ranking?k=15")
        _, rt = _req(f"{server}/sessions/{st}/ranking?k=15")
        assert rc["top"] == rt["top"]
        np.testing.assert_allclose(rc["scores"], rt["scores"], atol=1e-4)


def test_failed_learn_is_a_500_and_keeps_the_session(server, monkeypatch):
    """A refit that fails answers 500 and leaves the session as it was."""
    sid = _make(server, 5)
    _req(f"{server}/sessions/{sid}/feedback", "POST", {"labels": {"10": 1, "60": -1}})
    _, before = _req(f"{server}/sessions/{sid}/ranking?k=10")
    bad = GPHyper(length_scale=torch.tensor(2.5), var=torch.tensor(1.0),
                  noise=torch.tensor(-5.0))
    monkeypatch.setattr(hyperopt, "fit_hyperparams", lambda *a, **k: bad)
    code, err = _req(f"{server}/sessions/{sid}/learn", "POST", {"steps": 3})
    assert code == 500 and "LinAlgError" in err["error"]
    assert _req(f"{server}/sessions/{sid}/ranking?k=10")[1] == before


# -- the two packages on one request script -------------------------------

def _drive(base):
    """A request script: two ITAL sessions through the cohort endpoints, a
    density session through the single ones, rankings, a re-learn.  The
    user answers the class truth of ``_corpus`` (40 items a class), skipping
    the first item of every batch."""
    out = {"batches": [], "labeled": [], "rankings": []}
    sessions = {name: _make(base, q, body) for name, q, body in
                (("a", 5, {}), ("c", 47, {}), ("sud", 85, {"strategy": "sud"}))}
    cls = {"a": 0, "c": 1, "sud": 2}

    def answer(name, batch):
        return {str(i): (0 if j == 0 else (1 if i // 40 == cls[name] else -1))
                for j, i in enumerate(batch)}

    # Warm the posteriors: with the query alone MI saturates, and its argmax
    # order is decided by the last ulp.
    for name, sid in sessions.items():
        warm = [(q + s) % 120 for q in (5,) for s in (11, 31, 60, 90)]
        _req(f"{base}/sessions/{sid}/feedback", "POST", {"labels": answer(name, [0] + warm)})
    for _ in range(3):
        _, r = _req(f"{base}/batch_select", "POST",
                    {"session_ids": [sessions["a"], sessions["c"]], "k": 3})
        picks = {n: r["batches"][sessions[n]] for n in ("a", "c")}
        picks["sud"] = _req(f"{base}/sessions/{sessions['sud']}/batch?k=3")[1]["batch"]
        out["batches"].append(picks)
        _, r = _req(f"{base}/batch_feedback", "POST",
                    {"feedback": {sessions[n]: answer(n, picks[n]) for n in ("a", "c")}})
        out["labeled"].append({n: r["sessions"][sessions[n]]["labeled"] for n in ("a", "c")})
        _, r = _req(f"{base}/sessions/{sessions['sud']}/feedback", "POST",
                    {"labels": answer("sud", picks["sud"])})
        out["labeled"][-1]["sud"] = r["labeled"]
    for n, sid in sessions.items():
        out["rankings"].append(_req(f"{base}/sessions/{sid}/ranking?k=10")[1])
    out["learned"] = _req(f"{base}/sessions/{sessions['a']}/learn", "POST", {"steps": 20})[1]
    out["rankings"].append(_req(f"{base}/sessions/{sessions['a']}/ranking?k=10")[1])
    return out


def test_request_script_answers_like_the_jax_service():
    """Batches, rankings and labeled counts equal; learned values to 1e-4."""
    kw = dict(length_scale=2.5, noise=0.1, cap=32, strategy="ital", label_prob=0.8,
              mistake_prob=0.1, method_kwargs={"n_qmc": 64})
    results = []
    for svc in (jserve.RetrievalService(_corpus(3), **kw),
                RetrievalService(_corpus(3), device="cpu", **kw)):
        srv, t, url = _serve(svc)
        try:
            results.append(_drive(url))
        finally:
            srv.shutdown()
            srv.server_close()
            t.join(timeout=30)
    want, got = results
    assert got["batches"] == want["batches"]
    assert got["labeled"] == want["labeled"]
    for g, w in zip(got["rankings"], want["rankings"]):
        assert g["top"] == w["top"]
        np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-4)
    np.testing.assert_allclose([got["learned"][f] for f in ("length_scale", "var", "noise")],
                               [want["learned"][f] for f in ("length_scale", "var", "noise")],
                               rtol=1e-4)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_snapshot_restores_across_packages(direction):
    """A snapshot of either package's session restores in the other: the
    same ranking, options and query, and the same next batch."""
    x = _corpus(4)
    kw = dict(length_scale=2.5, noise=0.1, cap=32, strategy="ital", label_prob=0.9,
              mistake_prob=0.05, method_kwargs={"n_qmc": 32})
    jsvc = jserve.RetrievalService(x, **kw)
    tsvc = RetrievalService(x, device="cpu", **kw)
    src, dst = (jsvc, tsvc) if direction == "jax_to_torch" else (tsvc, jsvc)
    sid = src.create_session(method_kwargs={"pool_size": 30})
    src.set_query(sid, 5)
    src.feedback(sid, {"14": 1, "63": -1, "100": 0, "7": 1})
    rid = dst.restore(src.snapshot(sid))
    want, got = src.ranking(sid, 15), dst.ranking(rid, 15)
    assert got["top"] == want["top"]
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-6)
    restored, _ = dst._entry(rid)
    assert restored.method_kwargs == {"n_qmc": 32, "pool_size": 30} and restored.query == 5
    assert dst.next_batch(rid, 3) == src.next_batch(sid, 3)
    assert dst.feedback(rid, {"20": 1}) == src.feedback(sid, {"20": 1}) == {"labeled": 9}


def test_snapshot_under_concurrent_feedback_is_never_torn():
    """Snapshots taken while another thread posts feedback each hold one
    consistent state: mu = v^T beta, and nothing written past the count."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3000, 16)).astype(np.float32)
    svc = RetrievalService(x, length_scale=4.0, noise=0.1, cap=64, strategy="random",
                           device="cpu")
    sid = svc.create_session()
    svc.set_query(sid, 0)
    done = threading.Event()

    def writer():
        try:
            for j in range(15):
                svc.feedback(sid, {str(10 + j): 1 if j % 2 else -1})
        finally:
            done.set()

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    blobs = []
    try:
        t = threading.Thread(target=writer)
        t.start()
        while not done.is_set():
            blobs.append(svc.snapshot(sid))
        t.join(timeout=120)
        assert not t.is_alive()
        # The loop's last snapshot may precede the last write.
        blobs.append(svc.snapshot(sid))
    finally:
        sys.setswitchinterval(prev)
    counts = set()
    for blob in blobs:
        with np.load(io.BytesIO(blob)) as z:
            c = int(z["state_count"])
            v, beta, mu = z["state_v"], z["state_beta"], z["state_mu"]
            counts.add(c)
            assert not v[c:].any() and not beta[c:].any() and not z["state_idx"][c:].any()
            np.testing.assert_allclose(v.T @ beta, mu, atol=1e-4)
    assert max(counts) == 61


# -- entry points: the card by default, and the mesh --------------------------

def test_service_runs_on_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RetrievalService(_corpus(), length_scale=2.5)
    cfg = tconfig.load_config(str(ROOT / "configs" / "toy.ini"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.service_from_config(cfg)
    with pytest.raises(SystemExit) as exc:
        serve.main(["configs/toy.ini"])
    assert exc.value.code == 2
    svc = serve.service_from_config(cfg, device="cpu")
    assert svc.x.device.type == "cpu" and svc.health()["n"] == svc.x.shape[0]


def test_mesh_serves_from_every_entry_point(monkeypatch):
    """``mesh_devices`` / ``--mesh`` serve on a gloo mesh of CPU processes
    when asked for the CPU, and fail without a card otherwise."""
    svc = RetrievalService(_corpus(), length_scale=2.5, mesh_devices=2, device="cpu")
    try:
        assert svc.health()["mesh_devices"] == 2 and svc.health()["n"] == 120
        sid = svc.create_session()
        svc.set_query(sid, 3)
        assert len(svc.next_batch(sid, 2)) == 2
    finally:
        svc.close()
    cfg = tconfig.load_config(str(ROOT / "configs" / "toy.ini"), ("DATA.n_per_class=20",))
    svc = serve.service_from_config(cfg, mesh_devices=2, device="cpu")
    try:
        assert svc.health()["mesh_devices"] == 2 and svc.x.device.type == "cpu"
    finally:
        svc.close()
    p = subprocess.Popen(
        [sys.executable, "-m", "ital_tpu_torch.serve", "configs/toy.ini", "DATA.n_per_class=20",
         "--port", "0", "--mesh", "2", "--device", "cpu"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    watchdog = threading.Timer(120, p.kill)  # a server that never starts fails the test
    watchdog.start()
    try:
        line = p.stdout.readline()
        assert line.startswith("# serving toy on http://127.0.0.1:"), (line, p.stderr.read())
        assert "mesh of 2" in line
        code, h = _req(f"{line.split()[4]}/healthz")
        assert code == 200 and h["mesh_devices"] == 2 and h["device"] == "cpu"
    finally:
        watchdog.cancel()
        p.terminate()
        assert p.wait(timeout=60) == 0  # SIGTERM closes the mesh and exits cleanly
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        serve.main(["configs/toy.ini", "--mesh", "2"])
    assert exc.value.code == 2
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RetrievalService(_corpus(), length_scale=2.5, mesh_devices=2)


def test_module_serves_a_config_on_the_cpu():
    """``python -m ital_tpu_torch.serve <config> --port 0 --device cpu``
    serves until it is stopped."""
    p = subprocess.Popen(
        [sys.executable, "-m", "ital_tpu_torch.serve", "configs/toy.ini", "DATA.n_per_class=20",
         "--port", "0", "--device", "cpu"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    watchdog = threading.Timer(120, p.kill)  # a server that never starts fails the test
    watchdog.start()
    try:
        line = p.stdout.readline()
        assert line.startswith("# serving toy on http://127.0.0.1:"), (line, p.stderr.read())
        url = line.split()[4]
        code, h = _req(f"{url}/healthz")
        assert code == 200 and h["device"] == "cpu" and h["n"] > 0
        sid = _make(url, 3)
        code, b = _req(f"{url}/sessions/{sid}/batch?k=2")
        assert code == 200 and len(b["batch"]) == 2
    finally:
        watchdog.cancel()
        p.terminate()
        p.wait(timeout=60)

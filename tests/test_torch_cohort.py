"""The port's stacked cohort programs against ``ital_tpu``'s vmapped ones.

``gp_update_stacked`` against ``jax.vmap(gp_update)`` over
``stack_session_states`` and against the port's per-session ``gp_update``;
``select_ital_stacked`` against ``jax.vmap(select_ital)`` (JAX's draws fed
through ``subsample_uniforms`` and ``qmc_shifts``) and against the port's
per-session selection, in every mode; the runner's ``query_batch`` and
``fused_sessions`` modes against JAX's curves on JAX's draws; and the
server's stacked cohort endpoints against single-session twins.  Toy sizes
(N <= 180, D <= 6, cap 16, K <= 3).  Sessions in one stack differ in their
counts and hyperparameters.  Tolerances: a stacked update equals per-session
ones to 1e-6 (f32) and 1e-12 (f64), the batched products reducing in
another order; JAX's update to 1e-5 in f32 and 1e-4 in f64 (the reference
takes some f64 products with f32 accumulation, which moves its f64 mean by
~1e-5); batches exactly, on warmed tie-free posteriors; AP curves to 1e-6.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ital_tpu import runner as jrunner
from ital_tpu.data.datasets import toy_gaussians
from ital_tpu.models import gp as jgp
from ital_tpu.select import ital as jital
from ital_tpu.select.base import StrategyParams as JaxParams
from ital_tpu.utils import config as jconfig
from ital_tpu_torch import runner as trunner
from ital_tpu_torch.data.user import feedback_from_uniforms
from ital_tpu_torch.models import gp as tgp
from ital_tpu_torch.ops import chol as tchol
from ital_tpu_torch.ops.kernels import rbf_kernel, rbf_sessions
from ital_tpu_torch.ops.mvn import orthant_probs_all_configs_tree, small_cholesky
from ital_tpu_torch.select import base as tbase
from ital_tpu_torch.select import ital as tital
from ital_tpu_torch.select.base import StrategyParams
from ital_tpu_torch.serve import RetrievalService
from ital_tpu_torch.utils import config as tconfig
from ital_tpu_torch.utils.metrics import average_precision, recall_at_k
from tests.test_torch_gp import jax_state_arrays
from tests.test_torch_ital import _jax_draws
from tests.test_torch_runner import jax_round_draws
from tests.test_torch_serve import _corpus

AXES = jgp.GPState(x=None, idx=0, y=0, valid=0, count=0, l=0, beta=0, v=0, mu=0, sig2=0,
                   hyper=jgp.GPHyper(length_scale=0, var=0, noise=0), density=None, x2=None)
FIELDS = ("idx", "y", "valid", "l", "beta", "v", "mu", "sig2")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# Three sessions over one corpus: (query, (length scale, var, noise), feedback
# blocks of 4).  Counts 5, 9 and 5; the third learned other hyperparameters.
SESSIONS = [
    (5, (1.5, 1.0, 0.1), [[11, 40, 90, 130]]),
    (70, (1.5, 1.0, 0.1), [[3, 100, 150, 20], [61, 62, 63, 64]]),
    (140, (1.2, 0.8, 0.05), [[30, 77, 160, 99]]),
]


def _jax_sessions(ds, dtype=np.float32):
    """The three sessions in JAX, each warmed with its blocks (one item of
    each block skipped)."""
    out = []
    for q, (ls, var, noise), blocks in SESSIONS:
        st = jgp.gp_set_query(jgp.gp_init(jnp.asarray(ds.x.astype(dtype)), ls, var, noise, cap=16),
                              jnp.asarray(q))
        if dtype == np.float64:  # the reference's slice offsets need one int type under x64
            st = st.replace(count=st.count.astype(jnp.int64))
        cls = int(ds.labels[q])
        for blk in blocks:
            ys = [1.0 if ds.relevance[i, cls] else -1.0 for i in blk]
            st = jgp.gp_update(st, jnp.asarray(blk, jnp.int32), jnp.asarray(ys, dtype),
                               jnp.asarray([True, True, False, True]))
        out.append(st)
    return out


@pytest.fixture(scope="module")
def toy():
    return toy_gaussians(n_per_class=60, n_classes=3, dim=2, seed=4)


@pytest.fixture(scope="module")
def warmed(toy):
    """The sessions in JAX and as port states."""
    js = _jax_sessions(toy)
    return js, [tgp.state_from_arrays(jax_state_arrays(s), "cpu") for s in js]


def _params(label_prob=0.9, mistake_prob=0.05):
    return (JaxParams(label_prob=jnp.asarray(label_prob), mistake_prob=jnp.asarray(mistake_prob)),
            StrategyParams.create("cpu", label_prob=label_prob, mistake_prob=mistake_prob))


# -- the stacked GP update ---------------------------------------------------

@pytest.mark.parametrize("dtype,atol_jax,atol_self", [(np.float32, 1e-5, 1e-6),
                                                      (np.float64, 1e-4, 1e-12)])
def test_gp_update_stacked_matches_jax_vmap_and_per_session(toy, dtype, atol_jax, atol_self):
    idx = np.array([[7, 33, 120, 171], [8, 14, 99, 150], [55, 56, 101, 12]], np.int64)
    y = np.array([[1, -1, 1, -1], [-1, 1, 1, 1], [1, 1, -1, -1]], dtype)
    valid = np.array([[1, 1, 0, 1], [1, 0, 1, 1], [1, 1, 1, 1]], bool)
    with jax.enable_x64(dtype == np.float64):
        js = _jax_sessions(toy, dtype)
        update = jax.jit(jax.vmap(jgp.gp_update, in_axes=(AXES, 0, 0, 0), out_axes=AXES))
        want = update(jgp.stack_session_states(js), jnp.asarray(idx, jnp.int32), jnp.asarray(y),
                      jnp.asarray(valid))
        want = {f: np.asarray(getattr(want, f)) for f in FIELDS + ("count",)}
        singles = [tgp.state_from_arrays(jax_state_arrays(s), "cpu") for s in js]
    st = tgp.stack_states(singles)
    assert st.counts == [5, 9, 5] and st.hyper_groups == [[0, 1], [2]]
    tgp.gp_update_stacked(st, torch.from_numpy(idx), torch.from_numpy(y), torch.from_numpy(valid))
    assert st.counts == [9, 13, 9] and list(want["count"]) == st.counts
    for k, s in enumerate(singles):
        tgp.gp_update(s, torch.from_numpy(idx[k]), torch.from_numpy(y[k]),
                      torch.from_numpy(valid[k]))
        assert s.count == st.counts[k]
        for f in FIELDS:
            got = getattr(st, f)[k].numpy()
            np.testing.assert_allclose(got, getattr(s, f).numpy(), atol=atol_self, err_msg=f)
            np.testing.assert_allclose(got, want[f][k], atol=atol_jax, err_msg=f)


def test_gp_update_stacked_capacity_raises_before_writing(warmed):
    _, ts = warmed
    st = tgp.stack_states(ts)
    before = st.v.clone()
    with pytest.raises(ValueError, match="capacity exceeded"):
        tgp.gp_update_stacked(st, torch.zeros(3, 8, dtype=torch.int64), torch.ones(3, 8),
                              torch.ones(3, 8, dtype=torch.bool))
    assert torch.equal(st.v, before) and st.counts == [5, 9, 5]


def test_unstack_into_writes_each_session_in_place(warmed):
    _, ts = warmed
    copies = [tgp.gp_session_copy(s) for s in ts]
    buffers = [s.v for s in copies]
    st = tgp.stack_states(copies)
    tgp.gp_update_stacked(st, torch.tensor([[1, 2, 3, 4]] * 3), torch.ones(3, 4),
                          torch.ones(3, 4, dtype=torch.bool))
    assert not torch.equal(copies[0].mu, st.mu[0])  # nothing reaches a session before
    tgp.unstack_into(st, copies)
    for k, s in enumerate(copies):
        assert s.v is buffers[k] and s.count == st.counts[k]
        assert torch.equal(s.mu, st.mu[k]) and torch.equal(s.l, st.l[k])


# -- batched building blocks -------------------------------------------------

def test_rbf_sessions_equals_per_session_blocks(rng):
    x = torch.from_numpy(rng.normal(size=(50, 6)).astype(np.float32))
    x2 = (x * x).sum(-1)
    a = x[torch.from_numpy(rng.integers(0, 50, size=(3, 4, 1)))][:, :, 0]  # (3, 4, 6)
    b = x[torch.from_numpy(rng.integers(0, 50, size=(3, 5, 1)))][:, :, 0]  # (3, 5, 6)
    ls = torch.tensor([1.5, 2.0, 1.5])
    var = torch.tensor([1.0, 0.7, 1.0])
    groups = tgp.hyper_groups(tgp.GPHyper(ls, var, torch.zeros(3)))
    assert groups == [[0, 2], [1]]
    diag = rbf_sessions(a, b, ls, var, groups)
    rows = rbf_sessions(a, x, ls, var, groups, b2=x2)
    cols = rbf_sessions(x, b, ls, var, groups, a2=x2)
    for k in range(3):
        np.testing.assert_allclose(diag[k], rbf_kernel(a[k], b[k], ls[k], var[k]), atol=1e-6)
        np.testing.assert_allclose(rows[k], rbf_kernel(a[k], x, ls[k], var[k]), atol=1e-6)
        np.testing.assert_allclose(cols[k], rbf_kernel(x, b[k], ls[k], var[k]), atol=1e-6)


@pytest.mark.parametrize("dtype,atol", [(np.float32, 1e-6), (np.float64, 1e-12)])
def test_chol_append_block_at_per_session_offsets(rng, dtype, atol):
    """Three factors appended at counts 2, 5 and 0 in one call equal three
    single appends."""
    cap, b, counts = 12, 4, [2, 5, 0]
    ls, lbs, lbbs = [], [], []
    for c in counts:
        a = rng.normal(size=(cap, cap))
        k = (a @ a.T / cap + 0.5 * np.eye(cap)).astype(dtype)
        act = np.arange(cap) < c
        ls.append(np.linalg.cholesky(np.where(act[:, None] & act[None], k + 0.1 * np.eye(cap),
                                              np.eye(cap))).astype(dtype))
        lbs.append(np.where(act[:, None], k[:, c:c + b], 0.0).astype(dtype))
        lbbs.append(k[c:c + b, c:c + b].copy())
    active = torch.tensor([[True, False, True, True], [True] * 4, [False, True, True, True]])
    noise = torch.tensor([0.1, 0.2, 0.05], dtype=torch.from_numpy(ls[0]).dtype)
    l = torch.from_numpy(np.stack(ls))
    tchol.chol_append_block(l, torch.from_numpy(np.stack(lbs)), torch.from_numpy(np.stack(lbbs)),
                            counts, active, noise)
    for k, c in enumerate(counts):
        one = torch.from_numpy(ls[k].copy())
        tchol.chol_append_block(one, torch.from_numpy(lbs[k]), torch.from_numpy(lbbs[k]), c,
                                active[k], noise[k])
        np.testing.assert_allclose(l[k].numpy(), one.numpy(), atol=atol)
    k_pad = torch.from_numpy(np.stack([ls[0] @ ls[0].T] * 3))
    act = torch.from_numpy(rng.random((3, cap)) < 0.7)
    batched = tchol.padded_cholesky(k_pad, act, noise)
    for k in range(3):
        np.testing.assert_allclose(batched[k], tchol.padded_cholesky(k_pad[k], act[k], noise[k]),
                                   atol=atol)


def test_orthant_tree_takes_one_shift_per_session(rng):
    """(K, 1, t) shifts broadcast over each session's candidates and equal
    the per-session calls with one shared shift."""
    k, p, m = 3, 5, 3
    mu = torch.from_numpy(rng.normal(size=(k, p, m)).astype(np.float32) * 0.5)
    a = rng.normal(size=(k, p, m, m))
    cov = torch.from_numpy((a @ a.transpose(0, 1, 3, 2) + m * np.eye(m)).astype(np.float32))
    chol = small_cholesky(cov)
    shift = torch.from_numpy(rng.random((k, m - 1)).astype(np.float32))
    got = orthant_probs_all_configs_tree(mu, chol, n_points=64, shift=shift[:, None, :])
    for s in range(k):
        want = orthant_probs_all_configs_tree(mu[s], chol[s], n_points=64, shift=shift[s])
        np.testing.assert_allclose(got[s], want, atol=1e-7)


def test_batched_user_and_metrics_equal_rows(rng):
    n, k, b = 60, 3, 4
    scores = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32))
    relevant = torch.from_numpy(rng.random((k, n)) < 0.3)
    exclude = torch.zeros((k, n), dtype=torch.bool)
    exclude[:, 0] = True
    batch = torch.from_numpy(rng.integers(0, n, size=(k, b)))
    u = torch.from_numpy(rng.random((2, k, b)).astype(np.float32))
    y, valid = feedback_from_uniforms(u[0], u[1], batch, relevant, 0.8, 0.1)
    ap = average_precision(scores, relevant, exclude)
    rec = recall_at_k(scores, relevant, 10, exclude)
    for s in range(k):
        ys, vs = feedback_from_uniforms(u[0, s], u[1, s], batch[s], relevant[s], 0.8, 0.1)
        assert torch.equal(y[s], ys) and torch.equal(valid[s], vs)
        np.testing.assert_allclose(float(ap[s]), float(average_precision(
            scores[s], relevant[s], exclude[s])), atol=1e-7)
        np.testing.assert_allclose(float(rec[s]), float(recall_at_k(
            scores[s], relevant[s], 10, exclude[s])), atol=1e-7)


# -- the stacked ITAL selection ----------------------------------------------

@pytest.mark.parametrize("kw", [
    {"pool_size": 25, "n_qmc": 32, "refine_top": 8, "refine_n_qmc": 256},
    {"pool_size": 25, "n_qmc": 32},
    {"n_qmc": 32, "refine_top": 16, "refine_n_qmc": 256},
    {"n_qmc": 32},
    {"subsample_size": 40, "n_qmc": 32},
    {"subsample_size": 40, "n_qmc": 32, "refine_top": 8, "refine_n_qmc": 256},
    {"pool_size": 25, "n_qmc": 32, "refine_top": 8, "refine_n_qmc": 256, "randomize_qmc": True},
    {"subsample_size": 40, "n_qmc": 32, "randomize_qmc": True},
], ids=["pool+refine", "pool", "full+refine", "full", "subsample", "subsample+refine",
        "pool+refine+randomize", "subsample+randomize"])
def test_select_stacked_matches_jax_vmap_and_per_session(warmed, kw):
    js, ts = warmed
    jp, tp = _params()
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    select = jax.jit(jax.vmap(lambda st, key: jital.select_ital(st, 3, key, jp, **kw),
                              in_axes=(AXES, 0)))
    want = np.asarray(select(jgp.stack_session_states(js), keys))
    n = ts[0].mu.shape[0]
    draws = [_jax_draws(key, n, 3) for key in keys]
    fed = {}
    if "subsample_size" in kw:
        fed["subsample_uniforms"] = torch.stack([u for u, _ in draws])
    if kw.get("randomize_qmc"):
        fed["qmc_shifts"] = [torch.stack([s[t] for _, s in draws]) for t in range(3)]
    got = tital.select_ital_stacked(ts, 3, [None] * 3, tp, **fed, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    for k, s in enumerate(ts):
        one = {"subsample_uniforms": fed["subsample_uniforms"][k]} if "subsample_uniforms" in fed \
            else {}
        if "qmc_shifts" in fed:
            one["qmc_shifts"] = draws[k][1]
        np.testing.assert_array_equal(tital.select_ital(s, 3, None, tp, **one, **kw).numpy(),
                                      got[k].numpy())


def test_select_stacked_draws_each_session_from_its_own_generator(warmed):
    """Unfed, session k draws from generators[k] in its own fetch's order:
    the stacked picks equal each session's own with a generator of the same
    seed."""
    _, ts = warmed
    _, tp = _params()
    kw = {"subsample_size": 40, "n_qmc": 32, "randomize_qmc": True}
    got = tital.select_ital_stacked(ts, 3,
                                    [torch.Generator().manual_seed(s) for s in (1, 2, 3)], tp, **kw)
    for k, s in enumerate(ts):
        one = tital.select_ital(s, 3, torch.Generator().manual_seed(k + 1), tp, **kw)
        np.testing.assert_array_equal(one.numpy(), got[k].numpy())


def test_stacked_lookup_loops_other_strategies(warmed):
    _, ts = warmed
    _, tp = _params()
    assert tbase.get_stacked_strategy("ital") is tital.select_ital_stacked
    emoc = tbase.get_stacked_strategy("emoc")
    got = emoc(ts, 2, [None] * 3, tp)
    for k, s in enumerate(ts):
        want = tbase.get_strategy("emoc")(s, 2, None, tp)
        np.testing.assert_array_equal(got[k].numpy(), want.numpy())


# -- the runner's cohort and fused modes -------------------------------------

def _run_cfg(mod, method, **kw):
    gp = dict(length_scale=1.5, var=1.0, noise=0.1, cap=16, learn_every=2, learn_steps=20,
              learn_lr=0.05)
    gp.update(kw.pop("gp", {}))
    base = dict(
        dataset="toy", dataset_kwargs=dict(n_per_class=40, n_classes=3, dim=2, seed=0),
        method=method, batch_size=2, n_rounds=3, repetitions=1, queries_per_class=1,
        max_classes=3, seed=0, gp=mod.GPConfig(**gp),
        user=mod.UserConfig(label_prob=0.8, mistake_prob=0.1),
        method_kwargs={"n_qmc": 32} if method == "ital" else {},
    )
    base.update(kw)
    return mod.ExperimentConfig(**base)


@pytest.fixture(scope="module")
def jax_serial():
    """JAX's serial curves with per-round re-learning, per method: what its
    cohort and fused programs equal (tests/test_runner.py, test_hyperopt.py)."""
    return {m: jrunner.run_experiment(_run_cfg(jconfig, m))["ap"]
            for m in ("ital", "uncertainty_sampling")}


@pytest.mark.parametrize("method", ["ital", "uncertainty_sampling"])
@pytest.mark.parametrize("mode", [{"query_batch": 2}, {"query_batch": 3},
                                  {"fused_sessions": True},
                                  {"query_batch": 2, "fused_sessions": True}],
                         ids=["qb2", "qb3", "fused", "qb2+fused"])
def test_runner_modes_equal_jax_curves(jax_serial, monkeypatch, capsys, method, mode):
    """Three sessions (qb2 leaves a short last cohort), a noisy user on JAX's
    draws, re-learning every 2 rounds, and GP.refit_every set, which these
    modes ignore with the reference's message."""
    monkeypatch.setattr(trunner, "round_draws", jax_round_draws)
    got = trunner.run_experiment(_run_cfg(tconfig, method, gp={"refit_every": 1}, **mode),
                                 device="cpu")
    assert got["ap"].shape == (3, 3)
    np.testing.assert_allclose(got["ap"], jax_serial[method], atol=1e-6)
    assert "refit_every is a serial/per-round-sharded feature" in capsys.readouterr().out
    keys = {"ap", "map", "select_ms", "update_ms", "select_ms_steady", "first_round_ms",
            "sessions", "dataset", "method"}
    assert keys <= set(got) and got["update_ms"] == 0.0
    if mode.get("query_batch"):
        assert got["query_batch"] == mode["query_batch"]
    else:
        assert got["fused"] is True


def test_runner_cohort_equals_the_jax_cohort_program(monkeypatch):
    """query_batch x fused_sessions against JAX's own vmapped fused program on
    the same configuration (refit_every set and ignored by both)."""
    kw = dict(gp={"refit_every": 1}, query_batch=2, fused_sessions=True)
    want = jrunner.run_experiment(_run_cfg(jconfig, "ital", **dict(kw, gp=dict(kw["gp"]))))
    monkeypatch.setattr(trunner, "round_draws", jax_round_draws)
    got = trunner.run_experiment(_run_cfg(tconfig, "ital", **kw), device="cpu")
    np.testing.assert_allclose(got["ap"], want["ap"], atol=1e-6)


def test_fused_ignores_the_serial_features_with_the_reference_message(tmp_path, capsys):
    got = trunner.run_experiment(_run_cfg(tconfig, "random", fused_sessions=True,
                                          checkpoint_dir=str(tmp_path / "ck"), resume=True),
                                 device="cpu")
    assert "checkpoint_dir/resume/profile_dir are serial-mode features" in capsys.readouterr().out
    assert got["fused"] is True and not (tmp_path / "ck").exists()


def test_runner_jsonl_fields_of_each_mode(tmp_path):
    for mode, fields in [({"query_batch": 2}, {"round", "ap", "round_ms", "query_batch"}),
                         ({"fused_sessions": True}, {"ap_curve", "session_ms"}),
                         ({"query_batch": 2, "fused_sessions": True},
                          {"ap_curve", "cohort_ms", "query_batch"})]:
        log = tmp_path / f"{len(fields)}{len(mode)}.jsonl"
        trunner.run_experiment(_run_cfg(tconfig, "random", log_jsonl=str(log), **mode),
                               device="cpu")
        rows = [json.loads(ln) for ln in log.read_text().splitlines()]
        assert len(rows) == (9 if "round" in fields else 3)
        assert set(rows[0]) == {"rep", "cls", "query"} | fields


# -- the server's stacked cohort endpoints -----------------------------------

MKW = {"n_qmc": 32, "pool_size": 30, "refine_top": 8, "refine_n_qmc": 128,
       "randomize_qmc": True}


def _cohort_service():
    """Three sessions and their twins: the same queries, labels and seeds;
    the last pair re-learned its hyperparameters."""
    svc = RetrievalService(_corpus(7), length_scale=2.5, noise=0.1, cap=32, strategy="ital",
                           label_prob=0.9, mistake_prob=0.05, method_kwargs=MKW, device="cpu")
    cohort, twins = [], []
    for q in (3, 47, 85):
        for out in (cohort, twins):
            sid = svc.create_session()
            svc.set_query(sid, q)
            svc.feedback(sid, {str((q + 11) % 120): 1, str((q + 31) % 120): 1,
                               str((q + 60) % 120): -1, str((q + 90) % 120): -1})
            out.append(sid)
    for sid in (cohort[2], twins[2]):
        svc.learn(sid, steps=10)
    return svc, cohort, twins


def _spy(monkeypatch, svc):
    calls = {"cohort": [], "stacked": 0}
    orig = svc._select_cohort_locked

    def cohort_spy(entries, k):
        calls["cohort"].append(tuple(sorted(sid for sid, _, _ in entries)))
        return orig(entries, k)

    stacked = tbase.STACKED["ital"]

    def stacked_spy(*args, **kwargs):
        calls["stacked"] += 1
        return stacked(*args, **kwargs)

    monkeypatch.setattr(svc, "_select_cohort_locked", cohort_spy)
    monkeypatch.setitem(tbase.STACKED, "ital", stacked_spy)
    return calls


def _round(svc, cohort, twins, r):
    picks = svc.next_batch_many(cohort, 3)
    for a, b in zip(cohort, twins):
        assert picks[a] == svc.next_batch(b, 3), r
    labels = {sid: {str(i): (1 if i % 2 else -1) for i in picks[sid]} for sid in cohort}
    got = svc.feedback_many(labels)
    for a, b in zip(cohort, twins):
        assert got[a] == svc.feedback(b, labels[a])
        sa, sb = svc._entry(a)[0].state, svc._entry(b)[0].state
        np.testing.assert_allclose(sa.mu.numpy(), sb.mu.numpy(), atol=1e-6)
        assert torch.equal(sa.idx, sb.idx) and sa.count == sb.count


def test_cohort_endpoints_run_one_stacked_program_and_equal_the_twins(monkeypatch):
    svc, cohort, twins = _cohort_service()
    hypers = {float(svc._entry(s)[0].state.hyper.length_scale) for s in cohort}
    assert len(hypers) == 2  # one session learned other hyperparameters
    calls = _spy(monkeypatch, svc)
    for r in range(2):
        _round(svc, cohort, twins, r)
    assert calls["cohort"] == [tuple(sorted(cohort))] * 2 and calls["stacked"] == 2


def test_cohort_budget_chunks_with_the_same_results(monkeypatch):
    svc, cohort, twins = _cohort_service()
    from ital_tpu_torch import serve

    per = 32 * 120 * 4  # one (cap, N) f32 buffer
    monkeypatch.setenv("ITAL_TPU_COHORT_STATE_BYTES", str(int(2 * serve.UPDATE_COPIES * per)))
    assert svc._max_cohort_sessions(32, serve.UPDATE_COPIES) == 2
    assert svc._max_cohort_sessions(32, *serve.SELECT_BUDGET["ital"]) == 1
    calls = _spy(monkeypatch, svc)
    _round(svc, cohort, twins, 0)
    assert len(calls["cohort"]) == 3 and calls["stacked"] == 3


@pytest.mark.parametrize("n,select,update", [(25_000, 79, 671), (1_000_000, 20, 16)])
def test_cohort_chunk_sizes_at_25k_and_1m_rows(monkeypatch, n, select, update):
    """The default budget's chunks at cap 64: the selection's MI term does not
    grow with N, so at 1M rows a selection still takes 20 sessions (charged
    as 16 (cap, N) copies each it took 2)."""
    from ital_tpu_torch import serve

    monkeypatch.delenv("ITAL_TPU_COHORT_STATE_BYTES", raising=False)
    assert serve.max_cohort_sessions(64, n, *serve.SELECT_BUDGET["ital"]) == select
    assert serve.max_cohort_sessions(64, n, serve.UPDATE_COPIES) == update


def test_a_failing_stacked_program_fails_the_request(monkeypatch):
    """No fallback: the request raises and no session moves."""
    svc, cohort, _ = _cohort_service()
    before = [svc._entry(s)[0].state.mu.clone() for s in cohort]

    def broken(*args, **kwargs):
        raise RuntimeError("stacked program failed")

    monkeypatch.setitem(tbase.STACKED, "ital", broken)
    with pytest.raises(RuntimeError, match="stacked program failed"):
        svc.next_batch_many(cohort, 3)
    monkeypatch.setattr(tgp, "gp_update_stacked", broken)
    with pytest.raises(RuntimeError, match="stacked program failed"):
        svc.feedback_many({sid: {"5": 1} for sid in cohort})
    for sid, mu in zip(cohort, before):
        st = svc._entry(sid)[0].state
        assert torch.equal(st.mu, mu) and st.count == 5


def test_density_cohort_runs_the_per_session_loop_in_one_call():
    svc = RetrievalService(_corpus(1), length_scale=2.5, noise=0.1, cap=32, strategy="sud",
                           device="cpu")
    sids = [svc.create_session() for _ in range(2)]
    for sid, q in zip(sids, (3, 47)):
        svc.set_query(sid, q)
        svc.feedback(sid, {str((q + 11) % 120): 1, str((q + 60) % 120): -1})
    singles = {sid: svc.next_batch(sid, 3) for sid in sids}
    assert svc.next_batch_many(sids, 3) == singles
    dens = svc._entry(sids[0])[0].state.density
    svc.feedback_many({sid: {"20": 1} for sid in sids})
    assert all(svc._entry(sid)[0].state.density is dens for sid in sids)

"""The cohort and fused-session programs (``ital_tpu_torch.graphs``) against
``ital_tpu``'s compiled ones.

The stacked ITAL selection against the reference service's
``_batched_select``, the stacked GP update against its ``_cohort_update``,
the runner's cohort round against ``round_v`` and its fused cohort against
``fused_v`` (``make_fused_session_fn``), each on shared numpy inputs with
JAX's draws fed in; on the CPU every program runs its body eagerly, with the
counts on the device, the group index cached on the device and the draws fed
in.  Then the device-count forms against the host-count forms they replace,
and the graph path itself through the stand-in graph
(``tests/test_torch_graphs.py``): a repeated K replays, a new K captures and
the least recently used cohort program goes, a padded last cohort replays the
full cohort's program, a failed Cholesky check leaves all K sessions as they
were, a failed capture raises and nothing runs eagerly, and replays count
their launches.

Sizes: the 600-row surrogate of ``test_torch_graphs.py``, cap 32, cohorts of
K = 2, 3 and 4 sessions with differing counts and two hyperparameter groups.
Tolerances (``test_torch_cohort.py``'s): against JAX 1e-5 in f32 and 1e-4 in
f64 (the reference takes some f64 products with f32 accumulation); against
the host-count form 1e-6 in f32 and 1e-12 in f64 (a list of sessions is
stacked in the layout of their factors, a stack made by ``stack_states``
row-major); picks exactly; the graph path against its eager run bit for bit.
"""

import contextlib
import dataclasses
import gc
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ital_tpu import runner as jrunner
from ital_tpu import serve as jserve
from ital_tpu.data import datasets as jds
from ital_tpu.models import gp as jgp
from ital_tpu.select import ital as jital
from ital_tpu.select.base import StrategyParams as JaxParams
from ital_tpu.utils import config as jconfig
from ital_tpu_torch import graphs
from ital_tpu_torch import runner as trunner
from ital_tpu_torch.data import datasets as tds
from ital_tpu_torch.models import gp as tgp
from ital_tpu_torch.ops import chol as tchol
from ital_tpu_torch.ops import kernels, rbf_hopper
from ital_tpu_torch.select import base
from ital_tpu_torch.select import ital as tital
from ital_tpu_torch.select.base import StrategyParams, labeled_mask
from ital_tpu_torch.serve import RetrievalService
from ital_tpu_torch.utils import config as tconfig
from ital_tpu_torch.utils import logging as trace
from tests.test_torch_gp import jax_state_arrays
from tests.test_torch_graphs import stand_in  # noqa: F401 (the stand-in graph fixture)
from tests.test_torch_ital import _jax_draws
from tests.test_torch_runner import jax_round_draws

N, D, CAP, LS = 600, 32, 32, 12.0
PRODUCTION_KW = {"pool_size": 256, "n_qmc": 32, "refine_top": 64, "refine_n_qmc": 512}
KW = {"production": PRODUCTION_KW,
      "subsample+randomize": {"subsample_size": 200, "n_qmc": 32, "refine_top": 16,
                              "refine_n_qmc": 64, "randomize_qmc": True}}
FIELDS = tgp.SESSION_FIELDS
# Sessions of a cohort: (query, (length scale, var, noise), warm blocks of 4).
# Any first K hold two hyperparameter groups and differing counts.
SPECS = [(17, (LS, 1.0, 0.1), 1), (240, (10.0, 0.8, 0.05), 2), (410, (LS, 1.0, 0.1), 0),
         (520, (10.0, 0.8, 0.05), 3)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def surrogate():
    return tds._synthetic_surrogate("mirflickr", N, D, 14, seed=3)


def _blocks(ds, q, n_blocks):
    """``n_blocks`` feedback blocks of 4 for the session of query ``q``: the
    indices, the user's labels and a skipped third item."""
    rng = np.random.default_rng(q)
    cls = int(ds.labels[q])
    out = []
    for _ in range(n_blocks):
        idx = rng.choice(np.delete(np.arange(ds.n), q), 4, replace=False)
        out.append((idx, np.where(ds.relevance[idx, cls], 1.0, -1.0),
                    np.array([True, True, False, True])))
    return out


def _jax_sessions(ds, specs, dtype=np.float32):
    """The sessions of ``specs`` in JAX, each warmed with its blocks."""
    out = []
    for q, (ls, var, noise), n_blocks in specs:
        st = jgp.gp_set_query(jgp.gp_init(jnp.asarray(ds.x.astype(dtype)), ls, var, noise,
                                          cap=CAP), jnp.asarray(q))
        if dtype == np.float64:  # the reference's slice offsets need one int type under x64
            st = st.replace(count=st.count.astype(jnp.int64))
        for idx, y, valid in _blocks(ds, q, n_blocks):
            st = jgp.gp_update(st, jnp.asarray(idx, jnp.int32), jnp.asarray(y, dtype),
                               jnp.asarray(valid))
        out.append(st)
    return out


def _port(js):
    return [tgp.state_from_arrays(jax_state_arrays(s), "cpu") for s in js]


def _copies(states):
    return [tgp.gp_session_copy(s) for s in states]


def _equal_states(a, b):
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert a.count == b.count


# -- the bodies against the reference's compiled programs -----------------------


@pytest.mark.parametrize("mode", list(KW))
@pytest.mark.parametrize("k", [2, 3, 4])
def test_stacked_select_matches_batched_select(surrogate, k, mode):
    """K sessions' stacked selection (their own states, stacked inside the
    program, counts and group index on the device, JAX's draws fed in) picks
    ``_batched_select``'s batches, and the host-count form on a
    ``stack_states`` stack picks the same."""
    kw = KW[mode]
    js = _jax_sessions(surrogate, SPECS[:k])
    ts = _port(js)
    jp = JaxParams(label_prob=jnp.asarray(0.8), mistake_prob=jnp.asarray(0.05))
    params_b = jax.tree_util.tree_map(lambda *leaves: jnp.stack(leaves), *[jp] * k)
    keys = jax.random.split(jax.random.PRNGKey(7), k)
    batched = jserve.RetrievalService._batched_select(
        types.SimpleNamespace(_batched_select_cache={}), "ital", 4, tuple(sorted(kw.items())))
    want = np.asarray(batched(js, keys, params_b))

    draws = [_jax_draws(key, N, 4) for key in keys]
    fed = {}
    if "subsample_size" in kw:
        fed["subsample_uniforms"] = torch.stack([u for u, _ in draws])
    if kw.get("randomize_qmc"):
        fed["qmc_shifts"] = [torch.stack([s[t] for _, s in draws]) for t in range(4)]
    tp = StrategyParams.create("cpu", label_prob=0.8, mistake_prob=0.05)
    got = tital.select_ital_stacked(ts, 4, [None] * k, tp, **fed, **kw)
    np.testing.assert_array_equal(got.numpy(), want)

    options = {o: v for o, v in kw.items() if o != "randomize_qmc"}
    shifts = tital._pack_shifts(fed["qmc_shifts"], 4) if "qmc_shifts" in fed else None
    host = tgp.stack_states(ts)
    assert len(host.hyper_groups) == 2 and len(set(host.counts)) > 1
    got_host = tital._stacked_picks(host, tp, batch_size=4, **options, qmc_shifts=shifts,
                                    subsample_uniforms=fed.get("subsample_uniforms"))
    assert torch.equal(got_host, got)


@pytest.mark.parametrize("dtype,atol_jax,atol_self", [(np.float32, 1e-5, 1e-6),
                                                      (np.float64, 1e-4, 1e-12)])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_update_stacked_matches_cohort_update(surrogate, k, dtype, atol_jax, atol_self):
    """The stacked update program on K sessions' own states reaches the
    reference's jitted cohort update, and the host-count form on a stack."""
    rng = np.random.default_rng(k)
    idx = np.stack([rng.choice(N, 4, replace=False) for _ in range(k)]).astype(np.int64)
    y = np.where(rng.random((k, 4)) < 0.5, 1.0, -1.0).astype(dtype)
    valid = rng.random((k, 4)) < 0.8
    with jax.enable_x64(dtype == np.float64):
        js = _jax_sessions(surrogate, SPECS[:k], dtype)
        update = jserve.RetrievalService._cohort_update(
            types.SimpleNamespace(_batched_update_cache={}), k)
        outs, counts = update(js, jnp.asarray(idx, jnp.int32), jnp.asarray(y),
                              jnp.asarray(valid))
        want = [{f: np.asarray(getattr(o, f)) for f in FIELDS} for o in outs]
        ts = _port(js)
    host = tgp.stack_states(_copies(ts))
    tgp.gp_update_stacked(host, torch.from_numpy(idx), torch.from_numpy(y),
                          torch.from_numpy(valid))
    tgp.update_stacked(ts, torch.from_numpy(idx), torch.from_numpy(y), torch.from_numpy(valid))
    assert [s.count for s in ts] == host.counts == [int(c) for c in np.asarray(counts)]
    for j, s in enumerate(ts):
        for f in FIELDS:
            got = getattr(s, f).numpy()
            np.testing.assert_allclose(got, want[j][f], atol=atol_jax, err_msg=f)
            np.testing.assert_allclose(got, getattr(host, f)[j].numpy(), atol=atol_self,
                                       err_msg=f)


def _run_cfg(mod, **kw):
    gp = dict(length_scale=LS, var=1.0, noise=0.1, cap=CAP)
    gp.update(kw.pop("gp", {}))
    # Plan seed 2: at seeds 0 and 1 the two packages' serial runs part at an
    # f32 MI tie in round 2 (on the same state each picks the other's batch).
    base = dict(dataset="mirflickr", method="ital", batch_size=4, n_rounds=3, repetitions=1,
                queries_per_class=2, max_classes=2, seed=2, gp=mod.GPConfig(**gp),
                user=mod.UserConfig(label_prob=0.8, mistake_prob=0.05),
                method_kwargs=dict(PRODUCTION_KW))
    base.update(kw)
    return mod.ExperimentConfig(**base)


@pytest.fixture(scope="module")
def jax_surrogate():
    return jds._synthetic_surrogate("mirflickr", N, D, 14, seed=3)


@pytest.mark.parametrize("mode", [
    {"query_batch": 3},
    {"query_batch": 2, "fused_sessions": True, "gp": {"learn_every": 2, "learn_steps": 10}},
], ids=["qb3 (round_v, a padded last cohort)", "qb2+fused+learn (fused_v)"])
def test_runner_cohort_programs_match_round_v_and_fused_v(surrogate, jax_surrogate,
                                                          monkeypatch, mode):
    """Four sessions at the production options through the runner's cohort
    programs on JAX's draws reach the curves of the reference's ``round_v``
    (one program per cohort round) and ``fused_v`` (one program per cohort,
    re-learning inside it), with the picks the fused program returns."""
    want = jrunner.run_experiment(_run_cfg(jconfig, **dict(mode, gp=dict(mode.get("gp", {})))),
                                  jax_surrogate)
    monkeypatch.setattr(trunner, "round_draws", jax_round_draws)
    got = trunner.run_experiment(_run_cfg(tconfig, **mode), surrogate, device="cpu")
    np.testing.assert_allclose(got["ap"], want["ap"], atol=1e-5)
    assert got["picks"].shape == (4, 3, 4)
    for row in got["picks"].reshape(-1, 4):
        assert len(set(row.tolist())) == 4


def _tie_gap(state, theirs, ours, kw) -> float:
    """Where ``ours`` first parts from ``theirs`` (two batches picked greedily
    on the reference's ``state`` with the production options), the relative
    gap between the refined MI of the two picks of that step, with the
    shared earlier picks as the partial batch, computed by the reference
    (``ital_tpu.select.ital``); 0 where the batches agree."""
    t = next((t for t in range(len(theirs)) if theirs[t] != ours[t]), None)
    if t is None:
        return 0.0
    params = JaxParams(label_prob=jnp.asarray(0.8), mistake_prob=jnp.asarray(0.05))
    pair = jnp.asarray([theirs[t], ours[t]], jnp.int32)
    if t:
        mu_b, cov_bb, cross, sig2 = jital._joint_posterior(
            state, jnp.asarray(theirs, jnp.int32), t, params.jitter)
        cross = cross[pair]
    else:
        dt = state.mu.dtype
        mu_b, cov_bb, cross = jnp.zeros((0,), dt), jnp.zeros((0, 0), dt), jnp.zeros((2, 0), dt)
        sig2 = state.sig2 + params.jitter
    mi = np.asarray(jital.mi_scores_from_moments(state.mu[pair], sig2[pair], cross, mu_b,
                                                 cov_bb, params, t=t,
                                                 n_qmc=kw["refine_n_qmc"]), np.float64)
    return float(abs(mi[0] - mi[1]) / np.abs(mi).max())


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mode", [
    {"query_batch": 3},
    {"query_batch": 2, "fused_sessions": True, "gp": {"learn_every": 2, "learn_steps": 10}},
], ids=["qb3 (round_v)", "qb2+fused+learn (fused_v)"])
def test_runner_cohort_programs_part_from_the_reference_only_at_mi_ties(
        surrogate, jax_surrogate, monkeypatch, mode, seed):
    """At plan seeds 0 and 1, where the two packages' runs part: the
    runner's cohort programs on JAX's draws pick the reference's batches
    round by round (its serial run's: the reference's ``round_v`` and
    ``fused_v`` return no picks, and at these seeds part from its serial
    run at ties of their own) up to the first round where a session's
    batches part, with the same curves; there the two batches are an MI
    tie, the refined MI of their first differing picks within 1e-5
    relative, as the reference's own MI functions score them on its
    recorded state."""
    record = []
    make = jrunner.make_step_fns

    def recording(cfg):
        select_step, absorb_step = make(cfg)

        def spy(state, key, params):
            batch = select_step(state, key, params)
            record.append((state, np.asarray(batch)))
            return batch

        return spy, absorb_step

    monkeypatch.setattr(jrunner, "make_step_fns", recording)
    want = jrunner.run_experiment(
        _run_cfg(jconfig, gp=dict(mode.get("gp", {})), seed=seed), jax_surrogate)
    monkeypatch.setattr(trunner, "round_draws", jax_round_draws)
    got = trunner.run_experiment(_run_cfg(tconfig, **dict(mode, seed=seed)), surrogate,
                                 device="cpu")
    n_sess, rounds = want["ap"].shape
    assert len(record) == n_sess * rounds and got["picks"].shape == (n_sess, rounds, 4)
    for k in range(n_sess):
        theirs = [record[k * rounds + r][1].tolist() for r in range(rounds)]
        ours = got["picks"][k].tolist()
        r = next((r for r in range(rounds) if theirs[r] != ours[r]), rounds)
        np.testing.assert_allclose(got["ap"][k, :r], want["ap"][k, :r], atol=1e-5)
        if r < rounds:
            gap = _tie_gap(record[k * rounds + r][0], theirs[r], ours[r], PRODUCTION_KW)
            assert gap <= 1e-5, (k, r, theirs[r], ours[r], gap)


# -- device counts and the device group index against the host forms -------------


@pytest.mark.parametrize("blocks", [(1, 1, 1), (1, 2, 0)], ids=["equal", "differing"])
def test_device_counts_equal_host_counts(surrogate, blocks):
    """At equal and at differing counts the (K,) device counts give the host
    counts' slots, masks, writes, appends and stacked update, bit for bit."""
    specs = [(q, hyper, n) for (q, hyper, _), n in zip(SPECS, blocks)]
    host = tgp.stack_states(_port(_jax_sessions(surrogate, specs)))
    counts = torch.tensor(host.counts)
    assert torch.equal(tchol.slot_rows(counts, 4, "cpu"), tchol.slot_rows(host.counts, 4, "cpu"))
    dev = dataclasses.replace(host, counts=counts, **{f: getattr(host, f).clone() for f in FIELDS})
    assert torch.equal(dev.active, host.active)
    assert torch.equal(labeled_mask(dev), labeled_mask(host))

    rng = np.random.default_rng(0)
    buf = torch.from_numpy(rng.normal(size=(3, CAP, 5)))
    vals = torch.from_numpy(rng.normal(size=(3, 4, 5)))
    a, b = buf.clone(), buf.clone()
    tchol.write_slots(a, host.counts, vals)
    tchol.write_slots(b, counts, vals)
    assert torch.equal(a, b)

    k_lb = torch.from_numpy(rng.normal(size=(3, CAP, 4))) * 0.1
    k_lb = torch.where(host.active[..., None], k_lb.to(host.l.dtype), 0.0)
    k_bb = torch.eye(4, dtype=host.l.dtype).expand(3, 4, 4) * 2.0
    active = torch.tensor([[True, False, True, True]] * 3)
    l_host, l_dev = host.l.clone(), host.l.clone()
    out_host = tchol.chol_append_block(l_host, k_lb, k_bb, host.counts, active, host.hyper.noise)
    out_dev = tchol.chol_append_block(l_dev, k_lb, k_bb, counts, active, host.hyper.noise)
    for x, y in zip(out_host, out_dev):
        assert torch.equal(x, y)

    idx = torch.from_numpy(np.stack([rng.choice(N, 4, replace=False) for _ in range(3)]))
    y = torch.tensor([[1.0, -1.0, 1.0, 1.0]] * 3)
    valid = torch.tensor([[True, True, False, True]] * 3)
    tgp.gp_update_stacked(host, idx, y, valid)
    tgp.gp_update_stacked(dev, idx, y, valid)
    for f in FIELDS:
        assert torch.equal(getattr(dev, f), getattr(host, f)), f
    assert dev.counts.tolist() == host.counts


def test_group_index_is_cached_on_the_device(surrogate):
    """The groups' indices are built once per plan and device; the stacked
    blocks they gather equal each session's own block."""
    assert kernels.group_index((0, 2), torch.device("cpu")) is kernels.group_index(
        (0, 2), torch.device("cpu"))
    st = tgp.stack_states(_port(_jax_sessions(surrogate, SPECS[:3])))
    assert st.hyper_groups == [[0, 2], [1]]
    xs = st.x[st.idx[:, :6]]
    h = st.hyper
    got = kernels.rbf_sessions(xs, st.x, h.length_scale, h.var, st.hyper_groups, b2=st.x2)
    for j in range(3):
        want = kernels.rbf_kernel(xs[j], st.x, h.length_scale[j], h.var[j], b2=st.x2)
        np.testing.assert_allclose(got[j].numpy(), want.numpy(), atol=1e-6)


# -- the graph path, with a stand-in graph -------------------------------------------

MKW = dict(PRODUCTION_KW, randomize_qmc=True)


def _service(ds, cap=CAP):
    return RetrievalService(ds.x, length_scale=LS, noise=0.1, cap=cap, label_prob=0.8,
                            mistake_prob=0.05, method_kwargs=MKW, device="cpu")


def _sessions(svc, queries):
    """Sessions of ``queries``, every other one at another length scale (two
    hyperparameter groups), the first absorbing one block more; set up
    eagerly, so that only the cohort programs are captured."""
    sids = []
    with graphs.eager():
        for j, q in enumerate(queries):
            sid = svc.create_session(length_scale=LS if j % 2 == 0 else 10.0)
            svc.set_query(sid, q)
            sids.append(sid)
        svc.feedback(sids[0], {str(q + 1): 1 for q in range(4)})
    return sids


def _programs(name):
    return [p for p in graphs.programs() if p.name == name]


def test_cohort_endpoints_replay_per_k_and_equal_eager(surrogate, stand_in):
    """Through the graph path the cohort endpoints pick the eager service's
    batches and keep its posteriors bit for bit; a repeated K replays its
    programs and a new K captures."""
    svc = _service(surrogate)
    queries = [17, 240, 410, 520]
    graphed, plain = _sessions(svc, queries), _sessions(svc, queries)
    for r in range(2):
        got = svc.next_batch_many(graphed[:3], 4)
        with graphs.eager():
            want = svc.next_batch_many(plain[:3], 4)
        assert [got[s] for s in graphed[:3]] == [want[s] for s in plain[:3]], r
        labels = [{str(i): (1 if i % 3 else -1) for i in got[s]} for s in graphed[:3]]
        svc.feedback_many(dict(zip(graphed, labels)))
        with graphs.eager():
            svc.feedback_many(dict(zip(plain, labels)))
        for a, b in zip(graphed, plain):
            _equal_states(svc._entry(a)[0].state, svc._entry(b)[0].state)
    assert stand_in == ["select_ital_stacked", "gp_update_stacked"]
    assert [p.replays for p in graphs.programs()] == [2, 2]
    first = _programs("select_ital_stacked")[0]
    svc.next_batch_many(graphed[:2], 4)  # a new K captures
    assert stand_in[-1] == "select_ital_stacked" and len(_programs("select_ital_stacked")) == 2
    svc.next_batch_many(graphed[:3], 4)  # K = 3 again replays
    assert len(stand_in) == 3 and first.replays == 3


def _stage_bytes() -> int:
    return sum(stage.nbytes for stage in graphs.stages())


def test_stacking_programs_keep_their_stacks_within_the_budget(surrogate, stand_in,
                                                              monkeypatch):
    """The stages that the programs stacking sessions bind keep at most
    ``graphs.STACK_BYTES`` together, each counted once: a stage that would
    pass it first releases the least recently used other stage and the
    programs bound to it.  Cohorts of caps 32 and 16 share the stages of the
    fields whose slices do not depend on the cap (``mu``, ``sig2``)."""
    wide, narrow = _service(surrogate), _service(surrogate, cap=16)
    sids = {32: _sessions(wide, [17, 240, 410]), 16: _sessions(narrow, [33, 77, 520])}
    svcs = {32: wide, 16: narrow}
    wide.next_batch_many(sids[32], 4)
    alone = _stage_bytes()  # the stages of cap 32
    narrow.next_batch_many(sids[16], 4)
    both = _stage_bytes()
    assert len(graphs.stages()) == 2 * len(FIELDS) - 2 and alone < both
    assert both <= graphs.STACK_BYTES
    for prog in graphs.programs():  # every list input at its stage's address
        for stage in prog.stages:
            assert prog.inputs[stage.key[1]].data_ptr() == stage.buffer.data_ptr()
    graphs._PROGRAMS.clear()
    graphs._STAGES.clear()
    monkeypatch.setattr(graphs, "STACK_BYTES", both - 1)
    before = len(stand_in)
    for cap in (32, 16, 32, 16):  # each cap's stages fit only without the other's
        svcs[cap].next_batch_many(sids[cap], 4)
        assert _stage_bytes() <= graphs.STACK_BYTES
        (prog,) = _programs("select_ital_stacked")
        assert prog.inputs["l"].shape[1] == cap
    assert len(stand_in) - before == 4
    assert graphs._RELEASED[[k for k in graphs._RELEASED][-1]] == "stack_bytes"
    kept = {stage.key[1] for stage in graphs.stages()}
    assert {"mu", "sig2"} <= kept


def test_cohort_programs_of_every_width_bind_one_stage_per_field(surrogate, stand_in):
    """A selection of 4 sessions and then updates of 2, 3 and 4 in
    alternation bind one stage per field: every program's list inputs lie
    at their stage's address, each K captures once, and each call equals
    the eager one bit for bit."""
    queries = [17, 240, 410, 520]
    svc = _service(surrogate)
    graphed, plain = _sessions(svc, queries), _sessions(svc, queries)
    for r, k in enumerate((2, 3, 4, 3, 2, 4)):
        got = svc.next_batch_many(graphed, 4)
        with graphs.eager():
            want = svc.next_batch_many(plain, 4)
        assert [got[s] for s in graphed] == [want[s] for s in plain], r
        assert len(graphs.stages()) == len(FIELDS)
        labels = [{str(i): (1 if (i + r) % 3 else -1) for i in got[s]} for s in graphed[:k]]
        captured = len(stand_in)
        svc.feedback_many(dict(zip(graphed, labels)))
        with graphs.eager():
            svc.feedback_many(dict(zip(plain, labels)))
        assert len(stand_in) - captured == (1 if r < 3 else 0), (r, k)
        for a, b in zip(graphed, plain):
            _equal_states(svc._entry(a)[0].state, svc._entry(b)[0].state)
    assert [svc._entry(s)[0].state.count for s in graphed] == [29, 25, 17, 9]
    assert stand_in == ["select_ital_stacked"] + ["gp_update_stacked"] * 3
    stages = {stage.key[1]: stage for stage in graphs.stages()}
    assert sorted(stages) == sorted(FIELDS)
    assert all(stage.buffer.shape[0] == 4 for stage in stages.values())
    for prog in graphs.programs():
        assert {stage.key[1] for stage in prog.stages} == set(FIELDS)
        for f in FIELDS:
            assert prog.inputs[f].data_ptr() == stages[f].buffer.data_ptr(), (prog.name, f)
            assert prog.inputs[f].stride() == stages[f].buffer.stride(), (prog.name, f)
    assert sorted(p.inputs["v"].shape[0] for p in _programs("gp_update_stacked")) == [2, 3, 4]


def test_a_wider_cohort_grows_the_stage_and_releases_the_programs_bound_to_it(surrogate,
                                                                             stand_in):
    """A K larger than its stages hold grows them: the programs bound to the
    old buffers are released, and their next capture is named
    ``after_stage_grown``."""
    svc = _service(surrogate)
    sids = _sessions(svc, [17, 240, 410, 520])
    svc.next_batch_many(sids[:2], 4)
    svc.next_batch_many(sids[:3], 4)  # grows the stages from 2 to 3
    (held,) = graphs.programs()
    assert held.inputs["mu"].shape[0] == 3
    assert all(stage.buffer.shape[0] == 3 for stage in graphs.stages())
    with trace.recording():
        svc.next_batch_many(sids[:2], 4)
    captures = [s for seg in trace.segments() for s in seg.spans if s.name == "graphs.capture"]
    assert [(s.attrs["cause"], s.attrs["stage"]) for s in captures] == [
        ("after_stage_grown", "reused")]
    assert len(graphs.programs()) == 2 and stand_in == ["select_ital_stacked"] * 3
    trace.clear()


def test_cohort_programs_depend_on_group_sizes_not_order(surrogate, stand_in):
    """The cohort endpoints lay a group out by hyperparameter group, larger
    groups first (``hyper_group_order``): cohorts of K = 3 with two sessions
    of one group and one of the other replay one selection program whatever
    their order and mix, and pick each session's eager batch."""
    queries = [17, 240, 410, 520, 33, 77]
    svc = _service(surrogate)
    graphed, plain = _sessions(svc, queries), _sessions(svc, queries)
    states = [svc._entry(s)[0].state for s in graphed]
    assert tgp.hyper_group_order(states[:3]) == [0, 2, 1]
    assert tgp.hyper_group_order([states[1], states[0], states[3]]) == [0, 2, 1]
    for cohort in ([0, 1, 2], [1, 3, 4], [5, 0, 3], [4, 2, 1]):
        got = svc.next_batch_many([graphed[j] for j in cohort], 4)
        with graphs.eager():  # the twins in another order
            want = svc.next_batch_many([plain[j] for j in reversed(cohort)], 4)
        assert [got[graphed[j]] for j in cohort] == [want[plain[j]] for j in cohort]
    (prog,) = _programs("select_ital_stacked")
    assert prog.replays == 4 and stand_in == ["select_ital_stacked"]


def test_cohort_program_registry():
    """ITAL's selection registers a cohort program body, keyed by its static
    options; so does every other strategy, keyed by its name and options;
    an unknown one raises."""
    prog = base.cohort_program("ital", 4, MKW)
    assert prog.static == tuple(sorted(PRODUCTION_KW.items()))
    drawn = prog.draw([torch.Generator().manual_seed(1)] * 2, N, torch.float32, "cpu")
    assert drawn["subsample_uniforms"] is None and drawn["qmc_shifts"].shape == (2, 4, 4)
    emoc = base.cohort_program("emoc", 4, {})
    assert emoc.static == ("emoc", ()) and emoc.draw([None] * 2, N, torch.float32, "cpu") == {}
    assert set(base.COHORT_PROGRAMS) == set(base.STRATEGIES)
    with pytest.raises(KeyError, match="unknown strategy"):
        base.cohort_program("nope", 4, {})


@pytest.mark.parametrize("mode,programs,captures", [
    ({"query_batch": 3}, {"cohort_round": 2 * 3}, 1),
    ({"query_batch": 3, "fused_sessions": True, "gp": {"learn_every": 2, "learn_steps": 5}},
     {"fused_session": 2}, 1),
    ({"fused_sessions": True}, {"fused_session": 4}, 1),
    ({"query_batch": 3, "method": "emoc", "method_kwargs": {}}, {"cohort_round": 2 * 3}, 1),
    ({"query_batch": 3, "gp": {"learn_every": 2, "learn_steps": 5}}, {"cohort_round": 2 * 3},
     3),
], ids=["qb3", "qb3+fused+learn", "fused", "qb3 emoc", "qb3+learn"])
def test_runner_programs_replay_and_equal_eager(surrogate, stand_in, mode, programs, captures):
    """The runner's cohort round and fused cohort through the graph path give
    the eager run's curves and picks; the padded last cohort replays the full
    cohort's program.  With ``GP.learn_every`` a fused cohort's rounds and
    re-learns stay one program, and unfused the re-learning round captures a
    signature of its own (before it, one hyperparameter group; after it,
    singletons: three programs)."""
    cfg = _run_cfg(tconfig, **dict(mode, gp=dict(mode.get("gp", {}))))
    before = graphs.captures()
    graphed = trunner.run_experiment(cfg, surrogate, device="cpu")
    assert graphs.captures() - before == captures
    with graphs.eager():
        eager = trunner.run_experiment(cfg, surrogate, device="cpu")
    assert np.array_equal(graphed["ap"], eager["ap"])
    assert np.array_equal(graphed["picks"], eager["picks"])
    by_name = {}
    for p in graphs.programs():
        by_name[p.name] = by_name.get(p.name, 0) + p.replays
    assert by_name == programs
    assert stand_in == [next(iter(programs))] * captures


@pytest.mark.parametrize("mode", ["graphed", "eager", "shared stage"])
def test_failed_cholesky_check_leaves_all_sessions_unchanged(surrogate, stand_in, mode):
    """A block that is not positive definite in one session raises the
    Cholesky error once the stacked update ran, and no write reaches any of
    the K sessions; also where the update of 3 binds stages that an update
    of 4 made, whose sessions keep what it wrote."""
    ts = _port(_jax_sessions(surrogate, SPECS[:3]))
    ts[1].hyper.noise = torch.tensor(-2.0)
    before = _copies(ts)
    idx = torch.tensor([[3, 4, 5, 6]] * 4)
    ones = torch.ones(4, 4), torch.ones(4, 4, dtype=torch.bool)
    others = _port(_jax_sessions(surrogate, SPECS))
    if mode == "shared stage":
        tgp.update_stacked(others, idx, *ones)
    wrote = _copies(others)
    with graphs.eager() if mode == "eager" else contextlib.nullcontext():
        with pytest.raises(torch.linalg.LinAlgError, match="not positive-definite"):
            tgp.update_stacked(ts, idx[:3], ones[0][:3], ones[1][:3])
    for a, b in zip([*ts, *others], [*before, *wrote]):
        _equal_states(a, b)
    replays = {"graphed": [1], "eager": [], "shared stage": [1, 1]}[mode]
    assert [p.replays for p in graphs.programs()] == replays
    if mode == "shared stage":
        four, three = graphs.programs()
        assert three.stages == four.stages and len(graphs.stages()) == len(FIELDS)
        assert three.inputs["l"].data_ptr() == four.inputs["l"].data_ptr()


def test_failed_capture_raises_and_never_runs_eagerly(surrogate, stand_in, monkeypatch):
    """A capture that fails raises from the cohort endpoints and the runner;
    no call falls back to the eager body, and no session moves."""
    def failing(name, body, buffers, shared, device, mesh):
        raise graphs.CaptureError(f"capturing program {name!r} failed: stand-in")

    monkeypatch.setattr(graphs, "_capture_graph", failing)
    svc = _service(surrogate)
    sids = _sessions(svc, [17, 240, 410])
    before = [tgp.gp_session_copy(svc._entry(s)[0].state) for s in sids]
    with pytest.raises(graphs.CaptureError, match="select_ital_stacked"):
        svc.next_batch_many(sids, 4)
    with pytest.raises(graphs.CaptureError, match="gp_update_stacked"):
        svc.feedback_many({s: {"5": 1, "6": -1} for s in sids})
    for s, b in zip(sids, before):
        _equal_states(svc._entry(s)[0].state, b)
    with pytest.raises(graphs.CaptureError, match="cohort_round"):
        trunner.run_experiment(_run_cfg(tconfig, query_batch=2), surrogate, device="cpu")
    assert graphs.programs() == []


def test_cohort_replays_count_the_launches_their_capture_recorded(surrogate, stand_in):
    """Every replay of a cohort program adds the kernel launches its capture
    recorded: one per hyperparameter group and RBF block."""
    svc = _service(surrogate)
    sids = _sessions(svc, [17, 240, 410])
    rbf_hopper.reset_launch_counts()
    svc.next_batch_many(sids, 4)
    (prog,) = _programs("select_ital_stacked")
    per_replay = sum(prog.launches.values())
    assert per_replay == 2 * 2 * 3  # groups x blocks (x greedy steps 1-3)
    assert rbf_hopper.LAUNCHES == per_replay
    svc.next_batch_many(sids, 4)
    assert rbf_hopper.LAUNCHES == 2 * per_replay == rbf_hopper.ROUTE_LAUNCHES["wgmma"]


def test_programs_of_a_dead_corpus_are_released_at_the_next_capture(surrogate, stand_in):
    """A program keeps no corpus alive; once its corpus is gone the next
    capture releases it, static buffers and all."""
    def cohort(n):
        x = torch.from_numpy(surrogate.x[:n].copy())
        return [tgp.gp_set_query(tgp.gp_init(x, LS, 1.0, 0.1, CAP), q) for q in (3, 40)]

    block = (torch.tensor([[5, 6, 7, 8]] * 2), torch.ones(2, 4), torch.ones(2, 4, dtype=torch.bool))
    first = cohort(N)
    tgp.update_stacked(first, *block)
    (old,) = graphs.programs()
    old.graph.shared = {}  # the stand-in holds the corpus to recompute; a graph does not
    del first
    gc.collect()
    assert graphs.programs() == [old]  # released only at a capture
    second = cohort(N - 100)
    tgp.update_stacked(second, *block)
    (new,) = graphs.programs()
    assert new is not old and old.graph is None and old.inputs == {}

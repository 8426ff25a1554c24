"""The port's captured programs (``ital_tpu_torch.graphs``) and what made the
round capture-safe, against ``ital_tpu``.

On the CPU every program runs its body eagerly; these tests hold the bodies
against the reference's compiled programs (``_jit_select``,
``_update_donated``, ``entry``'s round step), the device-count and
device-table forms against the host forms they replace, and the graph path
itself (signature cache, copy-in and copy-back, deferred checks, launch
accounting, refusal to fall back) through a stand-in graph that recomputes
the body into the captured buffers at each replay.  The capture on a card is
held by ``tests/test_torch_cuda.py`` (JAX-free, for the card) and
``chip_smoke.py``.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from ital_tpu.models import gp as jgp
from ital_tpu.models import session as jsession
from ital_tpu.ops import mvn as jmvn
from ital_tpu.select import ital as jital
from ital_tpu.select.base import StrategyParams as JaxParams
from ital_tpu.utils.metrics import average_precision as jax_average_precision
from ital_tpu_torch import graphs, runner
from ital_tpu_torch.data import datasets as tds
from ital_tpu_torch.models import gp as tgp
from ital_tpu_torch.models.session import ActiveRetrieval, update_program
from ital_tpu_torch.ops import chol as tchol
from ital_tpu_torch.ops import kernels, rbf_hopper
from ital_tpu_torch.ops import mvn as tmvn
from ital_tpu_torch.round import round_step
from ital_tpu_torch.select import ital as tital
from ital_tpu_torch.select.base import StrategyParams
from tests.oracle.numpy_oracle import OracleGP
from tests.test_torch_gp import jax_state_arrays

# The production selection (configs/mirflickr_production.ini) cut to a small
# surrogate: a pool of 256 of 600 rows, n_qmc 32, the top 64 re-scored at 512.
PRODUCTION_KW = {"pool_size": 256, "n_qmc": 32, "refine_top": 64, "refine_n_qmc": 512}
N, D, CAP, LS = 600, 32, 32, 12.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def surrogate():
    return tds._synthetic_surrogate("mirflickr", N, D, 14, seed=3)


def _session_state(ds, query=17, cap=CAP):
    return tgp.gp_set_query(tgp.gp_init(torch.from_numpy(ds.x), LS, 1.0, 0.1, cap), query)


def _warm(ts, ds, rounds=2, seed=0):
    """``ts`` with ``rounds`` blocks of 4 random labels absorbed, in place."""
    rng = np.random.default_rng(seed)
    for _ in range(rounds):
        idx = torch.from_numpy(rng.choice(ds.n, 4, replace=False))
        y = torch.from_numpy(np.where(rng.random(4) < 0.5, 1.0, -1.0).astype(np.float32))
        tgp.gp_update(ts, idx, y, torch.tensor([True, True, False, True]))
    return ts


def _copy(ts):
    return tgp.gp_session_copy(ts)


def _assert_states_equal(a, b):
    for f in tgp.SESSION_FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert int(a.count) == int(b.count)


# --- device tables -------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_device_tables_equal_host_tables_and_reference(m, dtype):
    """The cached sign / feedback tables and the feedback table built from
    them, and the cached lattice, are bit-equal to the host tables and to
    ``ital_tpu``'s."""
    signs, fb = tital.device_tables(m, torch.device("cpu"))
    np.testing.assert_array_equal(signs.numpy(), jital.sign_table(m))
    np.testing.assert_array_equal(fb.numpy(), jital.feedback_table(m))
    assert tital.device_tables(m, torch.device("cpu"))[0] is signs  # cached

    lp, mp = 0.8, 0.05
    got = tital.feedback_given_relevance(m, torch.tensor(lp, dtype=dtype),
                                         torch.tensor(mp, dtype=dtype))
    # The table as the eager port built it from the host tables.
    r = torch.as_tensor(tital.sign_table(m))[:, None, :]
    f = torch.as_tensor(tital.feedback_table(m))[None, :, :]
    lp_t, mp_t = torch.tensor(lp, dtype=dtype), torch.tensor(mp, dtype=dtype)
    old = torch.prod(torch.where(f == 0.0, 1.0 - lp_t,
                                 torch.where(f == r, lp_t * (1.0 - mp_t), lp_t * mp_t)), dim=-1)
    assert torch.equal(got, old)
    with jax.enable_x64(dtype == torch.float64):
        jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
        want = np.asarray(jital.feedback_given_relevance(m, jnp.asarray(lp, jdt),
                                                         jnp.asarray(mp, jdt)))
    np.testing.assert_array_equal(got.numpy(), want)

    for n_points in (32, 512):
        lat = tmvn.device_lattice(n_points, m, dtype, torch.device("cpu"))
        assert lat.dtype == dtype
        want = jmvn.richtmyer_lattice(n_points, m).astype(lat.numpy().dtype)
        np.testing.assert_array_equal(lat.numpy(), want)
        assert torch.equal(lat, torch.as_tensor(tmvn.richtmyer_lattice(n_points, m), dtype=dtype))
    shifts = tmvn.device_shift_table(5, m, 3, dtype, torch.device("cpu"))
    np.testing.assert_array_equal(shifts.numpy(),
                                  jmvn.shift_table(5, m, 3).astype(shifts.numpy().dtype))


# --- fed draws -------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {"subsample_size": 200, "n_qmc": 32, "refine_top": 16, "refine_n_qmc": 64},
    {"pool_size": 256, "n_qmc": 32, "randomize_qmc": True},
    {"subsample_size": 200, "n_qmc": 32, "randomize_qmc": True},
])
def test_fed_draws_pick_as_generator_draws(surrogate, kw):
    """Drawing first (``draw_selection_inputs``) and feeding the draws in
    picks what drawing inside the selection picks, and leaves the generator
    where the selection leaves it."""
    ts = _warm(_session_state(surrogate), surrogate)
    g_inside = torch.Generator().manual_seed(5)
    inside = tital.select_ital_stacked([ts], 4, [g_inside],
                                       StrategyParams.create("cpu", label_prob=0.8), **kw)[0]
    g = torch.Generator().manual_seed(5)
    u, shifts = tital.draw_selection_inputs(
        g, ts.x.shape[0], 4, ts.mu.dtype, ts.mu.device,
        subsample=bool(kw.get("subsample_size")), randomize=kw.get("randomize_qmc", False))
    fed = {k: v for k, v in kw.items() if k != "randomize_qmc"}
    got = tital.select_ital(ts, 4, None, StrategyParams.create("cpu", label_prob=0.8),
                            subsample_uniforms=u, qmc_shifts=shifts, **fed)
    assert torch.equal(got, inside)
    assert torch.equal(g.get_state(), g_inside.get_state())
    g_again = torch.Generator().manual_seed(5)
    again = tital.select_ital(ts, 4, g_again, StrategyParams.create("cpu", label_prob=0.8), **kw)
    assert torch.equal(again, inside)


# --- the bodies against the reference's compiled programs -----------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_select_and_absorb_bodies_match_reference_programs(surrogate, dtype):
    """Two rounds at the production options: the selection program's body
    picks ``_jit_select``'s batch, and the update program's body and the
    runner's absorb body reach ``_update_donated``'s posterior mean and the
    reference's AP: within 1e-5 in f32.  In f64 the reference takes its
    products in f32 (``preferred_element_type``), ~1e-7 off its own f64
    values, so there the means are held to 1e-6 of it and to 1e-8 of the
    f64 NumPy oracle (``tests/oracle``) on the same labels."""
    f64 = dtype == np.float64
    atol = 1e-6 if f64 else 1e-5
    ds = surrogate
    q = 17
    cls = int(ds.labels[q])
    relevant = ds.relevance[:, cls]
    exclude = np.zeros(ds.n, bool)
    exclude[q] = True
    kw_items = tuple(sorted(PRODUCTION_KW.items()))
    with jax.enable_x64(f64):
        jdt = jnp.float64 if f64 else jnp.float32
        js = jgp.gp_set_query(jgp.gp_init(jnp.asarray(ds.x.astype(dtype)), LS, 1.0, 0.1, CAP),
                              jnp.asarray(q))
        if f64:
            js = js.replace(count=jnp.asarray(js.count, jnp.int64))
        jp = JaxParams(label_prob=jnp.asarray(0.8, jdt), mistake_prob=jnp.asarray(0.05, jdt))
        ts = tgp.state_from_arrays(jax_state_arrays(js), "cpu")
        if f64:  # the reference's f64 query fit carries its f32 products
            ts = tgp.gp_fit(ts)
        ta = _copy(ts)  # the runner's absorb body on a twin
        tdt = torch.float64 if f64 else torch.float32
        tp = StrategyParams(*(torch.tensor(v, dtype=tdt) for v in (0.8, 0.05, 1e-6, 0.5)))
        rng = np.random.default_rng(1)
        for r in range(2):
            want = np.asarray(jsession._jit_select("ital", 4, kw_items)(
                js, jax.random.PRNGKey(r), jp))
            got = tital.select_ital(ts, 4, None, tp, **PRODUCTION_KW).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"round {r}")
            u_label, u_flip = rng.random(4).astype(dtype), rng.random(4).astype(dtype)
            truth = np.where(relevant[want], 1.0, -1.0)
            y = np.where(u_flip < 0.05, -truth, truth).astype(np.float32)
            valid = u_label < 0.8
            owned = {f: getattr(js, f) for f in jsession._UPDATE_OWNED}
            js = js.replace(**jsession._update_donated(
                owned, js.x, js.hyper, js.density, js.x2, jnp.asarray(want),
                jnp.asarray(y), jnp.asarray(valid)))
            update_program(ts, torch.from_numpy(want.astype(np.int64)), torch.from_numpy(y),
                           torch.from_numpy(valid))
            ta, ap, recalls = runner.absorb_step(
                ta, torch.from_numpy(want.astype(np.int64)), torch.from_numpy(u_label),
                torch.from_numpy(u_flip), torch.from_numpy(relevant),
                torch.from_numpy(exclude), tp)
            np.testing.assert_allclose(ts.mu.numpy(), np.asarray(js.mu), atol=atol)
            np.testing.assert_allclose(ta.mu.numpy(), np.asarray(js.mu), atol=atol)
            want_ap = float(jax_average_precision(js.mu, jnp.asarray(relevant),
                                                  jnp.asarray(exclude)))
            assert abs(float(ap) - want_ap) <= atol
            assert len(recalls) == len(runner.RECALL_KS)
            if f64:
                act = ts.active.numpy()
                oracle = OracleGP(ds.x.astype(np.float64), LS, 1.0, 0.1)
                oracle.fit(ts.idx.numpy()[act].tolist(), ts.y.numpy()[act].tolist())
                np.testing.assert_allclose(ts.mu.numpy(), oracle.predict_mean(), atol=1e-8)
                np.testing.assert_allclose(ta.mu.numpy(), oracle.predict_mean(), atol=1e-8)
        assert ts.count == ta.count == int(js.count) == 9


def test_round_step_with_jax_draws_matches_entry_round_step():
    """``round_step`` on ``entry``'s example state, fed the user's uniforms
    that ``entry``'s round step draws from its key, picks its batch and
    reaches its AP and posterior."""
    fn, (js, key, relevant, exclude, jp) = graft.entry()
    js2, jbatch, jap = jax.jit(fn)(js, key, relevant, exclude, jp)
    _, k_user = jax.random.split(key)
    k_label, k_flip = jax.random.split(k_user)
    u_label = torch.tensor(np.asarray(jax.random.uniform(k_label, (4,))))
    u_flip = torch.tensor(np.asarray(jax.random.uniform(k_flip, (4,))))
    ts = tgp.state_from_arrays(jax_state_arrays(js), "cpu")
    tp = StrategyParams.create("cpu", label_prob=float(jp.label_prob),
                               mistake_prob=float(jp.mistake_prob))
    ts, batch, ap = round_step(ts, None, torch.tensor(np.asarray(relevant)),
                               torch.tensor(np.asarray(exclude)), tp,
                               user_uniforms=(u_label, u_flip))
    np.testing.assert_array_equal(batch.numpy(), np.asarray(jbatch))
    assert abs(float(ap) - float(jap)) <= 1e-6
    np.testing.assert_allclose(ts.mu.numpy(), np.asarray(js2.mu), atol=1e-5)
    assert ts.count == int(js2.count) == 5


# --- device count against host count --------------------------------------


@pytest.mark.parametrize("count", list(range(0, 13)))
def test_device_count_update_equals_host_count(surrogate, count):
    """``gp_update`` at a 0-d device count writes what it writes at the host
    count, bit for bit, at every count a block of 4 fits into a cap of 16."""
    cap = 16
    ts = _session_state(surrogate, cap=cap)
    ts.count = count  # slots 1.. hold whatever gp_set_query left: identity rows
    rng = np.random.default_rng(count)
    idx = torch.from_numpy(rng.choice(surrogate.n, 4, replace=False))
    y = torch.tensor([1.0, -1.0, 1.0, -1.0])
    valid = torch.tensor([True, False, True, True])
    host = tgp.gp_update(_copy(ts), idx, y, valid)
    dev = _copy(ts)
    dev.count = torch.tensor(count)
    dev = tgp.gp_update(dev, idx, y, valid)
    _assert_states_equal(dev, host)


@pytest.mark.parametrize("rounds", [0, 1, 3, 6])
def test_device_count_selection_equals_host_count(surrogate, rounds):
    """The selection reads the labeled set through the count: a device count
    picks the host count's batch."""
    ts = _warm(_session_state(surrogate), surrogate, rounds=rounds)
    p = StrategyParams.create("cpu", label_prob=0.8, mistake_prob=0.05)
    host = tital._stacked_picks(tgp.stacked_view(ts), p, batch_size=4, **PRODUCTION_KW)
    dev = dataclasses.replace(tgp.stacked_view(_copy(ts)), counts=torch.tensor([ts.count]))
    got = tital._stacked_picks(dev, p, batch_size=4, **PRODUCTION_KW)
    assert torch.equal(got, host)
    assert torch.equal(tital.select_ital(ts, 4, None, p, **PRODUCTION_KW), host[0])


# --- the deferred Cholesky check -----------------------------------------


def _not_pd_block(ts):
    """A block whose Schur complement is not positive definite: a noise of
    -2 on its diagonal (the factor of the labels already absorbed keeps its
    own noise)."""
    ts.hyper.noise = torch.tensor(-2.0)
    return torch.tensor([3, 4, 5, 6]), torch.ones(4), torch.ones(4, dtype=torch.bool)


def test_deferred_cholesky_check_raises_cholesky_error(surrogate):
    """Inside a program the failed factorization is held back and raised
    after it, with ``torch.linalg.cholesky``'s own exception and message."""
    ts = _session_state(surrogate)
    idx, y, valid = _not_pd_block(ts)
    with pytest.raises(torch.linalg.LinAlgError) as eager:
        tgp.gp_update(_copy(ts), idx, y, valid)
    st = _copy(ts)
    st.count = torch.tensor(ts.count)
    with graphs._in_program() as checks:
        tgp.gp_update(st, idx, y, valid)  # nothing raised inside the program
    assert len(checks) == 1
    value, check = checks[0]
    with pytest.raises(torch.linalg.LinAlgError) as deferred:
        check(value)
    assert str(deferred.value) == str(eager.value)
    # The same text torch.linalg.cholesky gives, single and batched.
    bad = torch.tensor([[1.0, 2.0], [2.0, 1.0]])
    for mat in (bad, bad.expand(3, 2, 2)):
        with pytest.raises(torch.linalg.LinAlgError) as lib:
            torch.linalg.cholesky(mat)
        with pytest.raises(torch.linalg.LinAlgError) as ours:
            tchol.check_cholesky_info(torch.linalg.cholesky_ex(mat).info)
        assert str(ours.value) == str(lib.value)


# --- the graph path, with a stand-in graph ---------------------------------


class _StandInGraph:
    """Recomputes the body into the captured outputs and check values at
    each replay, as the captured graph rewrites its static buffers."""

    def __init__(self, body, shared, buffers, outputs, checks):
        self.body, self.shared, self.buffers = body, shared, buffers
        self.outputs, self.checks = outputs, checks

    def replay(self):
        # A graph's replay runs no Python: the launches it makes are counted
        # by the caller from its capture's record.
        with rbf_hopper.recording_launches(), graphs._in_program() as checks:
            new = self.body(**self.shared, **self.buffers)
        for out, val in zip(self.outputs, new):
            out.copy_(val)
        for (value, _), (val, _) in zip(self.checks, checks):
            value.copy_(val)


@pytest.fixture
def stand_in(monkeypatch):
    """Route CPU tensors through the graph path with :class:`_StandInGraph`
    and count the plain RBF calls as kernel launches; yields the capture
    log."""
    captured = []

    def capture_graph(name, body, buffers, shared, device, mesh):
        captured.append(name)
        with rbf_hopper.recording_launches() as launches, graphs._in_program() as checks:
            outputs = tuple(t.clone() for t in body(**shared, **buffers))
        graph = _StandInGraph(body, shared, buffers, outputs, checks)
        return graph, outputs, checks, launches, 0.0, 0.0, 0.0

    plain = kernels._rbf_forward

    def counted(*args):
        rbf_hopper._count_launch("wgmma")
        return plain(*args)

    monkeypatch.setattr(graphs, "_PROGRAMS", {})
    monkeypatch.setattr(graphs, "_STAGES", {})
    monkeypatch.setattr(graphs, "_GRAPH_DEVICES", ("cuda", "cpu"))
    monkeypatch.setattr(graphs, "_capture_graph", capture_graph)
    monkeypatch.setattr(kernels, "_rbf_forward", counted)
    yield captured


def _session(ds, seed=0):
    sess = ActiveRetrieval(ds.x, length_scale=LS, cap=CAP, label_prob=0.8, mistake_prob=0.05,
                           seed=seed, method_kwargs=PRODUCTION_KW, device="cpu")
    sess.update_query(17)
    return sess


def _feedback(ds, batch):
    return {int(i): (1 if ds.relevance[i, int(ds.labels[17])] else -1) for i in batch}


def test_graphed_session_equals_eager_session(surrogate, stand_in):
    """Through the graph path a session picks the eager session's batches
    and keeps its posterior bit for bit; its programs are captured once and
    replayed in the later rounds."""
    graphed, plain = _session(surrogate), _session(surrogate)
    for r in range(3):
        got = graphed.fetch_unlabelled(4)
        with graphs.eager():
            want = plain.fetch_unlabelled(4)
        np.testing.assert_array_equal(got, want)
        graphed.update(_feedback(surrogate, got))
        with graphs.eager():
            plain.update(_feedback(surrogate, want))
        _assert_states_equal(graphed.state, plain.state)
    assert stand_in == ["select_ital", "gp_update"]
    assert [p.replays for p in graphs.programs()] == [3, 3]


def test_repeated_signature_replays_and_new_signature_captures(surrogate, stand_in):
    """A second session over the same corpus replays the first one's
    programs; another batch size or another corpus captures anew."""
    first = _session(surrogate)
    first.update(_feedback(surrogate, first.fetch_unlabelled(4)))
    second = ActiveRetrieval(first.state.x, length_scale=LS, cap=CAP, label_prob=0.8,
                             mistake_prob=0.05, method_kwargs=PRODUCTION_KW, device="cpu")
    second.update_query(40)
    second.update(_feedback(surrogate, second.fetch_unlabelled(4)))
    assert stand_in == ["select_ital", "gp_update"]
    second.fetch_unlabelled(3)
    assert stand_in == ["select_ital", "gp_update", "select_ital"]
    third = ActiveRetrieval(surrogate.x.copy(), length_scale=LS, cap=CAP,  # another corpus
                            method_kwargs=PRODUCTION_KW, device="cpu")
    third.update_query(17)
    third.fetch_unlabelled(4)
    assert stand_in == ["select_ital", "gp_update", "select_ital", "select_ital"]
    assert len(graphs.programs()) == 4


def test_replays_count_the_launches_their_capture_recorded(surrogate, stand_in):
    """Every replay adds the kernel launches its capture recorded; the
    capture's own launches are not counted."""
    sess = _session(surrogate)
    rbf_hopper.reset_launch_counts()
    sess.fetch_unlabelled(4)
    (prog,) = graphs.programs()
    per_replay = sum(prog.launches.values())
    assert per_replay > 0
    # the warm-up is the stand-in's capture: only the replay counted
    assert rbf_hopper.LAUNCHES == per_replay
    sess.fetch_unlabelled(4)
    assert rbf_hopper.LAUNCHES == 2 * per_replay
    assert rbf_hopper.ROUTE_LAUNCHES["wgmma"] == 2 * per_replay


def test_failed_check_in_a_program_leaves_the_session_unchanged(surrogate, stand_in):
    """A block that is not positive definite raises the Cholesky error after
    the update program ran, and no write reaches the session."""
    sess = _session(surrogate)
    idx, y, valid = _not_pd_block(sess.state)
    before = _copy(sess.state)
    with pytest.raises(torch.linalg.LinAlgError, match="not positive-definite"):
        update_program(sess.state, idx, y, valid)
    _assert_states_equal(sess.state, before)
    assert graphs.programs()[0].replays == 1


def test_failed_capture_raises_and_never_runs_eagerly(surrogate, stand_in, monkeypatch):
    """A capture that fails raises; the call does not fall back to the
    eager body, and no program is kept."""
    def failing(name, body, buffers, shared, device, mesh):
        raise graphs.CaptureError(f"capturing program {name!r} failed: stand-in")

    monkeypatch.setattr(graphs, "_capture_graph", failing)
    sess = _session(surrogate)
    mu = sess.state.mu.clone()
    with pytest.raises(graphs.CaptureError, match="select_ital"):
        sess.fetch_unlabelled(4)
    with pytest.raises(graphs.CaptureError, match="gp_update"):
        sess.update({1: 1, 2: -1})
    assert torch.equal(sess.state.mu, mu) and sess.state.count == 1
    assert graphs.programs() == []


def test_graphed_round_step_and_absorb_equal_eager(surrogate, stand_in):
    """``round_step`` and the runner's absorb step through the graph path
    equal their eager runs, writes copied back and counts advanced."""
    ts = _warm(_session_state(surrogate), surrogate)
    relevant = torch.from_numpy(surrogate.relevance[:, 0])
    exclude = torch.zeros(surrogate.n, dtype=torch.bool)
    p = StrategyParams.create("cpu", label_prob=0.8, mistake_prob=0.05)
    u = (torch.rand(4, generator=torch.Generator().manual_seed(1)),
         torch.rand(4, generator=torch.Generator().manual_seed(2)))
    outs = {}
    for mode in ("graphed", "eager"):
        st = _copy(ts)
        with graphs.eager() if mode == "eager" else contextlib.nullcontext():
            st, batch, ap = round_step(st, None, relevant, exclude, p, user_uniforms=u)
            st, ap2, rec = runner.absorb_step(st, batch.flip(0), *u, relevant, exclude, p)
        outs[mode] = (st, batch, ap, ap2, rec)
    (g, gb, gap, gap2, grec), (e, eb, eap, eap2, erec) = outs["graphed"], outs["eager"]
    _assert_states_equal(g, e)
    assert torch.equal(gb, eb) and float(gap) == float(eap) and float(gap2) == float(eap2)
    assert [float(r) for r in grec] == [float(r) for r in erec]
    assert g.count == ts.count + 8
    assert sorted(p.name for p in graphs.programs()) == ["absorb_step", "round_step"]

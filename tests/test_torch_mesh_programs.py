"""The port's mesh programs (``ital_tpu_torch.parallel.sharded`` and its
callers through ``graphs.run(..., mesh=...)``) on the graph path, against
their eager calls and against ``ital_tpu.parallel.sharded``.

The CPU has no graph, so a stand-in (:class:`_StandInGraph`, as in
``tests/test_torch_graphs.py``) recomputes a program's body at each replay,
collectives included: a captured program runs its body at the capture and
again at the first replay, as a card's warm-up and replay do.  The spawned
ranks turn it on themselves (:func:`_stand_in`), the parent through a
fixture.  Each mesh is a gloo group of 1 (in-process), 2 or 4 CPU processes
over a 105-row toy corpus, which pads to 106 and 108 rows; the reference
runs at the same mesh size on the conftest's virtual CPU devices, and its
draws reach the port through its seams.  Graphed calls equal eager ones bit
for bit; batches equal the reference's, AP within 1e-5 and ``mu``/``sig2``
within 1e-5 (its f32 GP updates round otherwise), learned values within
1e-4 relative.  The two sessions of a cohort take different user models
(label and mistake probabilities, trade-off), and the noisy users keep MI
scores clear of ties.

The spawned ranks import this module, so it imports neither ``jax`` nor
``ital_tpu`` at its top: the reference runs in the test bodies, in the
parent process.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from ital_tpu_torch import graphs
from ital_tpu_torch.data.datasets import toy_gaussians
from ital_tpu_torch.models import gp as tgp
from ital_tpu_torch.models.hyperopt import LearnConfig
from ital_tpu_torch.ops import chol as tchol
from ital_tpu_torch.ops import kernels, rbf_hopper
from ital_tpu_torch.parallel import launch, make_mesh, sharded as sh
from ital_tpu_torch.select import STRATEGIES
from ital_tpu_torch.select.base import StrategyParams

LS, VAR, NOISE, CAP = 1.5, 1.0, 0.1, 16
B = 2  # batch size
ROUNDS = 3
USERS = (dict(label_prob=0.8, mistake_prob=0.1, tradeoff=0.5),
         dict(label_prob=0.95, mistake_prob=0.02, tradeoff=0.3))
QUERIES = (4, 60)
DENSITY = {"sud", "tcal", "adapt_al"}
STRATEGY_NAMES = sorted(STRATEGIES)
ITAL = {"n_qmc": 32}
PRODUCTION = {"n_qmc": 16, "pool_size": 24, "refine_top": 8, "refine_n_qmc": 64,
              "randomize_qmc": True}
LEARN = dict(every=2, steps=10, lr=0.05)
UPDATE = dict(idx=np.asarray([[7, 50, 88, 0], [20, 101, 3, 0]], np.int64),
              y=np.asarray([[1.0, -1.0, 1.0, 0.0], [-1.0, 1.0, 1.0, 0.0]], np.float32))
MESHES = (2, 4)
JAX_ATOL, AP_ATOL = 1e-5, 1e-5
FACTORIES = ("select", "round", "update", "set_query", "fit", "density", "session", "cohort",
             "cohort_select", "cohort_update")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _dataset():
    return toy_gaussians(n_per_class=35, n_classes=3, dim=2, seed=5)  # 105 rows


def _opts(strategy):
    return ITAL if strategy == "ital" else {}


# -- the stand-in graph ---------------------------------------------------------


class _StandInGraph:
    """Recomputes the body into the captured outputs and check values at
    each replay, as the captured graph rewrites its static buffers; its
    collectives run again, as a graph's do."""

    def __init__(self, body, shared, buffers, outputs, checks):
        self.body, self.shared, self.buffers = body, shared, buffers
        self.outputs, self.checks = outputs, checks

    def replay(self):
        with rbf_hopper.recording_launches(), graphs._in_program() as checks:
            new = self.body(**self.shared, **self.buffers)
        for out, val in zip(self.outputs, new):
            out.copy_(val)
        for (value, _), (val, _) in zip(self.checks, checks):
            value.copy_(val)


def _capture_graph(name, body, buffers, shared, device, mesh):
    with rbf_hopper.recording_launches() as launches, graphs._in_program() as checks:
        outputs = tuple(t.clone() for t in body(**shared, **buffers))
    return _StandInGraph(body, shared, buffers, outputs, checks), outputs, checks, launches, 0.0, \
        0.0, 0.0


_PLAIN_RBF = kernels._rbf_forward


def _counted_rbf(*args):
    rbf_hopper._count_launch("wgmma")
    return _PLAIN_RBF(*args)


def _stand_in() -> None:
    """Route this process's CPU tensors through the graph path with the
    stand-in graph, and count the plain RBF calls as kernel launches (a
    spawned rank's switch; the parent's goes through :func:`stand_in`)."""
    graphs._GRAPH_DEVICES = ("cuda", "cpu")
    graphs._capture_graph = _capture_graph
    kernels._rbf_forward = _counted_rbf


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(graphs, "_PROGRAMS", {})
    monkeypatch.setattr(graphs, "_STAGES", {})
    monkeypatch.setattr(graphs, "_GRAPH_DEVICES", ("cuda", "cpu"))
    monkeypatch.setattr(graphs, "_capture_graph", _capture_graph)
    monkeypatch.setattr(kernels, "_rbf_forward", _counted_rbf)


# -- the reference's side, in the parent ----------------------------------------


def _jax_params(user):
    import jax.numpy as jnp

    from ital_tpu.select.base import StrategyParams as JaxParams

    return JaxParams(**{k: jnp.asarray(v) for k, v in user.items()})


def _jax_user_draws(key):
    import jax

    _, k_user = jax.random.split(key)
    k_label, k_flip = jax.random.split(k_user)
    return (np.asarray(jax.random.uniform(k_label, (B,))),
            np.asarray(jax.random.uniform(k_flip, (B,))))


def _jax_setup(p):
    """The warmed states, masks, draws and every factory's reference result
    at mesh size ``p``."""
    import jax
    import jax.numpy as jnp

    from ital_tpu.models import gp as jgp
    from ital_tpu.parallel import make_mesh as jmesh, pad_to_devices, shard_state
    from ital_tpu.parallel import sharded as jsh
    from tests.test_torch_gp import jax_state_arrays

    ds = _dataset()
    x_pad, n = pad_to_devices(ds.x, p)
    n_pad = x_pad.shape[0]
    mesh = jmesh(p)
    state0 = jgp.gp_init(jnp.asarray(x_pad), LS, VAR, NOISE, cap=CAP)
    sel_forbid, _ = jsh.make_masks(n_pad, n, QUERIES[0])
    density = jsh.make_sharded_density(mesh)(shard_state(state0, mesh), sel_forbid)
    warmed, relevant, exclude = [], [], []
    for q in QUERIES:
        cls = int(ds.labels[q])
        picks = [11 + q % 7, 40, 75, 99]
        ys = [1.0 if ds.relevance[i, cls] else -1.0 for i in picks]
        warmed.append(jgp.gp_update(jgp.gp_set_query(state0, jnp.asarray(q)),
                                    jnp.asarray(picks, jnp.int32), jnp.asarray(ys, jnp.float32),
                                    jnp.ones(len(picks), bool)))
        relevant.append(np.pad(ds.relevance[:, cls], (0, n_pad - n)))
        exclude.append(np.asarray(jsh.make_masks(n_pad, n, q)[1]))
    keys = [jax.random.fold_in(jax.random.PRNGKey(3), i) for i in range(len(QUERIES))]
    users = [[_jax_user_draws(jax.random.fold_in(k, r)) for r in range(ROUNDS)] for k in keys]
    params = [_jax_params(u) for u in USERS]
    params_b = jax.tree.map(lambda *ls: jnp.stack(ls), *params)
    rel, exc = jnp.asarray(np.stack(relevant)), jnp.asarray(np.stack(exclude))
    out = {"n": n, "n_pad": n_pad, "states": [jax_state_arrays(w) for w in warmed],
           "state0": jax_state_arrays(state0), "density": np.asarray(density),
           "relevant": np.stack(relevant), "exclude": np.stack(exclude),
           "sel_forbid": np.asarray(sel_forbid), "users": users,
           "select_draws": [np.asarray(jax.random.uniform(k, (n_pad,), jnp.float32))
                            for k in keys], "jax": {}}
    got = out["jax"]

    def gathered(st):
        return {"mu": np.asarray(st.mu), "sig2": np.asarray(st.sig2)}

    def with_density(w, strategy):
        return w.replace(density=density) if strategy in DENSITY else w

    if p == 2:  # every strategy's cohort selection, each session its own user model
        got["cohort_select"] = {}
        for s in STRATEGY_NAMES:
            fn = jsh.make_sharded_cohort_select(mesh, strategy=s, batch_size=B, **_opts(s))
            states = tuple(shard_state(with_density(w, s), mesh) for w in warmed)
            got["cohort_select"][s] = np.asarray(fn(states, jnp.stack(keys), sel_forbid, params_b))
    rnd = jsh.make_sharded_round(mesh, strategy="ital", batch_size=B, recall_ks=(10,), **ITAL)
    st, batch, ap, recalls = rnd(shard_state(warmed[0], mesh), keys[0], rel[0], sel_forbid,
                                 exc[0], params[0])
    got["round"] = {"batch": np.asarray(batch), "ap": float(ap),
                    "recall": float(recalls[0]), **gathered(st)}
    out["round_users"] = _jax_user_draws(keys[0])
    upd = jsh.make_sharded_update(mesh)(shard_state(warmed[0], mesh),
                                        jnp.asarray(UPDATE["idx"][0], jnp.int32),
                                        jnp.asarray(UPDATE["y"][0]), jnp.asarray(UPDATE["y"][0] != 0))
    got["update"] = gathered(upd)
    got["set_query"] = gathered(jsh.make_sharded_set_query(mesh)(shard_state(state0, mesh),
                                                                 jnp.asarray(100)))
    refit = warmed[0].replace(hyper=warmed[0].hyper.replace(length_scale=jnp.asarray(2.0)))
    got["fit"] = gathered(jsh.make_sharded_fit(mesh)(shard_state(refit, mesh)))
    got["density"] = {"density": np.asarray(density)}
    kw = dict(strategy="ital", batch_size=B, n_rounds=ROUNDS, learn=jsh.LearnConfig(**LEARN),
              **ITAL)
    st, aps = jsh.make_sharded_session(mesh, **kw)(shard_state(warmed[0], mesh), keys[0], rel[0],
                                                   sel_forbid, exc[0], params[0])
    got["session"] = {"aps": np.asarray(aps), **gathered(st), "hyper": np.asarray(
        [st.hyper.length_scale, st.hyper.var, st.hyper.noise])}
    # A learning cohort's hyperparameters are per session too.
    stateb = warmed[0].replace(hyper=jax.tree.map(lambda *h: jnp.stack(h),
                                                  *[w.hyper for w in warmed]),
                               **{f: jnp.stack([getattr(w, f) for w in warmed])
                                  for f in ("idx", "y", "valid", "count", "l", "beta", "v",
                                            "mu", "sig2")})
    stb, aps = jsh.make_sharded_cohort(mesh, **kw)(jsh.shard_cohort_state(stateb, mesh),
                                                   jnp.stack(keys), rel, sel_forbid, exc,
                                                   params[0])
    got["cohort"] = {"aps": np.asarray(aps), "mu": np.asarray(stb.mu), "hyper": np.stack(
        [np.asarray(stb.hyper.length_scale), np.asarray(stb.hyper.var),
         np.asarray(stb.hyper.noise)], -1)}
    new, counts = jsh.make_sharded_cohort_update(mesh)(
        tuple(shard_state(w, mesh) for w in warmed), jnp.asarray(UPDATE["idx"], jnp.int32),
        jnp.asarray(UPDATE["y"]), jnp.asarray(UPDATE["y"] != 0))
    got["cohort_update"] = {"mu": np.stack([np.asarray(s.mu) for s in new]),
                            "sig2": np.stack([np.asarray(s.sig2) for s in new]),
                            "counts": np.asarray(counts)}
    return out


@pytest.fixture(scope="module")
def jax_side():
    return {p: _jax_setup(p) for p in MESHES}


# -- the port's side, on every rank ----------------------------------------------


class _Counted:
    """Counts the mesh's collective calls (the sums, the gathers and the
    ring) while it is entered."""

    NAMES = ("psum", "all_gather_cat", "ring_reduce_over_corpus")

    def __enter__(self):
        self.calls, self.saved = 0, {n: getattr(sh, n) for n in self.NAMES}

        def wrap(fn):
            def counted(*args, **kwargs):
                self.calls += 1
                return fn(*args, **kwargs)
            return counted

        for n, fn in self.saved.items():
            setattr(sh, n, wrap(fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(sh, n, fn)


def _params(k):
    return StrategyParams.create("cpu", **USERS[k])


def _shards(mesh, payload):
    """The warmed sessions' shards over one corpus shard (and its density),
    the initial state's, and the masks."""
    lo, hi = sh._bounds(mesh, payload["n_pad"] // mesh.size)
    density = torch.from_numpy(payload["density"][lo:hi]).contiguous()
    first = sh.shard_state(tgp.state_from_arrays(payload["states"][0], "cpu"), mesh)
    first.density = density
    warmed = [first] + [dataclasses.replace(
        sh.shard_state(tgp.state_from_arrays(a, "cpu"), mesh), x=first.x, x2=first.x2,
        density=density) for a in payload["states"][1:]]
    init = dataclasses.replace(sh.shard_state(tgp.state_from_arrays(payload["state0"], "cpu"),
                                              mesh), x=first.x, x2=first.x2)
    return warmed, init


def _copy(state, strategy=None):
    """A session's own buffers over the shared shard; the density only for
    the strategies that read it."""
    out = tgp.gp_session_copy(state)
    if strategy is not None and strategy not in DENSITY:
        out.density = None
    return out


def _gathered(mesh, state):
    return {f: sh.gather_mu(mesh, getattr(state, f)).numpy() for f in ("mu", "sig2")}


def _factory_cases(mesh, payload, warmed, init):
    """Each factory's call, as a function of nothing that builds its own
    inputs and returns its results as NumPy arrays."""
    pad = torch.from_numpy(payload["sel_forbid"])
    rel = torch.from_numpy(payload["relevant"])
    exc = torch.from_numpy(payload["exclude"])
    users = payload["users"]
    u = [torch.from_numpy(d) for d in payload["select_draws"]]
    idx, y = torch.from_numpy(UPDATE["idx"]), torch.from_numpy(UPDATE["y"])
    learn = LearnConfig(**LEARN)
    kw = dict(strategy="ital", batch_size=B, n_rounds=ROUNDS, learn=learn, **ITAL)

    def draws(k):
        return [(None, torch.from_numpy(users[k][r][0]), torch.from_numpy(users[k][r][1]))
                for r in range(ROUNDS)]

    def select():
        return {s: sh.make_sharded_select(mesh, strategy=s, batch_size=B, **_opts(s))(
            _copy(warmed[0], s), None, pad, _params(0),
            **({"uniforms": u[0]} if s == "random" else {})).numpy() for s in STRATEGY_NAMES}

    def production():
        g = torch.Generator().manual_seed(11)
        return {"batch": sh.make_sharded_select(mesh, strategy="ital", batch_size=B,
                                                **PRODUCTION)(
            _copy(warmed[0]), g, pad, _params(0), n_real=payload["n"]).numpy()}

    def round_():
        st = _copy(warmed[0])
        ul, uf = (torch.from_numpy(v) for v in payload["round_users"])
        st, batch, ap, recalls = sh.make_sharded_round(
            mesh, strategy="ital", batch_size=B, recall_ks=(10,), **ITAL)(
            st, None, ul, uf, rel[0], pad, exc[0], _params(0))
        return {"batch": batch.numpy(), "ap": ap.numpy(), "recall": recalls[0].numpy(),
                "count": np.asarray(st.count), **_gathered(mesh, st)}

    def update():
        st = sh.make_sharded_update(mesh)(_copy(warmed[0]), idx[0], y[0], y[0] != 0)
        return {"count": np.asarray(st.count), **_gathered(mesh, st)}

    def set_query():
        st = sh.make_sharded_set_query(mesh)(_copy(init), 100)
        return {"count": np.asarray(st.count), "idx": st.idx.numpy(), **_gathered(mesh, st)}

    def fit():
        st = _copy(warmed[0])
        st.hyper = dataclasses.replace(st.hyper, length_scale=torch.tensor(2.0))
        return _gathered(mesh, sh.make_sharded_fit(mesh)(st))

    def density():
        return {"density": sh.all_gather_cat(mesh, sh.make_sharded_density(mesh)(init, pad)).numpy()}

    def session():
        st, aps = sh.make_sharded_session(mesh, **kw)(_copy(warmed[0]), draws(0), rel[0], pad,
                                                     exc[0], _params(0))
        h = st.hyper
        return {"aps": aps.numpy(), **_gathered(mesh, st), "count": np.asarray(st.count),
                "hyper": torch.stack([h.length_scale, h.var, h.noise]).numpy()}

    def cohort():
        stb = tgp.stack_states([_copy(w) for w in warmed])
        k = len(warmed)
        cohort_draws = [([None] * k, torch.stack([torch.from_numpy(users[j][r][0])
                                                  for j in range(k)]),
                         torch.stack([torch.from_numpy(users[j][r][1]) for j in range(k)]))
                        for r in range(ROUNDS)]
        stb, aps = sh.make_sharded_cohort(mesh, **kw)(stb, cohort_draws, rel, pad, exc,
                                                      _params(0))
        h = stb.hyper
        return {"aps": aps.numpy(), "mu": sh.gather_mu(mesh, stb.mu).numpy(),
                "counts": np.asarray(stb.counts),
                "hyper": torch.stack([h.length_scale, h.var, h.noise], -1).numpy()}

    def cohort_select():
        params = StrategyParams.stack([_params(k) for k in range(len(warmed))])
        return {s: sh.make_sharded_cohort_select(mesh, strategy=s, batch_size=B, **_opts(s))(
            [_copy(w, s) for w in warmed], [None] * len(warmed), pad, params,
            **({"uniforms": torch.stack(u)} if s == "random" else {})).numpy()
            for s in STRATEGY_NAMES}

    def cohort_update():
        states = [_copy(w) for w in warmed]
        sh.make_sharded_cohort_update(mesh)(states, idx, y, y != 0)
        return {"counts": np.asarray([s.count for s in states]),
                "mu": np.stack([sh.gather_mu(mesh, s.mu).numpy() for s in states]),
                "sig2": np.stack([sh.gather_mu(mesh, s.sig2).numpy() for s in states])}

    return {"select": select, "production": production, "round": round_, "update": update,
            "set_query": set_query, "fit": fit, "density": density, "session": session,
            "cohort": cohort, "cohort_select": cohort_select, "cohort_update": cohort_update}


def _singles_and_counts(mesh, payload, warmed):
    """Each strategy's K single selects (each session with its own user
    model) and the collectives of its cohort selection at K = 1, 2, 4, run
    eagerly (a capture runs a body twice)."""
    pad = torch.from_numpy(payload["sel_forbid"])
    u = [torch.from_numpy(d) for d in payload["select_draws"]]
    singles, counts = {}, {}
    for s in STRATEGY_NAMES:
        one = sh.make_sharded_select(mesh, strategy=s, batch_size=B, **_opts(s))
        singles[s] = np.stack([one(_copy(w, s), None, pad, _params(k),
                                   **({"uniforms": u[k]} if s == "random" else {})).numpy()
                               for k, w in enumerate(warmed)])
        cohort = sh.make_sharded_cohort_select(mesh, strategy=s, batch_size=B, **_opts(s))
        counts[s] = {}
        for k in (1, 2, 4):
            members = [j % len(warmed) for j in range(k)]
            with _Counted() as c, graphs.eager():
                cohort([_copy(warmed[j], s) for j in members], [None] * k, pad,
                       StrategyParams.stack([_params(j) for j in members]),
                       **({"uniforms": torch.stack([u[j] for j in members])}
                          if s == "random" else {}))
            counts[s][k] = c.calls
    return singles, counts


def _refuse(info):
    raise torch.linalg.LinAlgError("not positive-definite (on purpose)")


def _failing_checks(mesh, warmed):
    """A check that fails inside the update programs: does every rank raise
    a check's failure, and leave its sessions as they were?  The blocks are
    3 wide, a signature of their own, so the programs are captured with the
    refusing check (a captured program keeps the checks of its capture)."""
    idx, y = torch.from_numpy(UPDATE["idx"][:, :3]), torch.from_numpy(UPDATE["y"][:, :3])
    saved = tchol.check_cholesky_info
    out = {}
    tchol.check_cholesky_info = _refuse
    try:
        for name, eager in (("graphed", False), ("eager", True)):
            one, many = _copy(warmed[0]), [_copy(w) for w in warmed]
            before = [tgp.gp_session_copy(s) for s in [one, *many]]
            raised = []
            for call in (lambda: sh.make_sharded_update(mesh)(one, idx[0], y[0], y[0] != 0),
                         lambda: sh.make_sharded_cohort_update(mesh)(many, idx, y, y != 0)):
                try:
                    with graphs.eager() if eager else contextlib.nullcontext():
                        call()
                    raised.append(False)
                except torch.linalg.LinAlgError as exc:
                    raised.append(graphs.uniform_failure(exc))
            same = all(torch.equal(getattr(a, f), getattr(b, f)) and a.count == b.count
                       for a, b in zip(before, [one, *many]) for f in tgp.SESSION_FIELDS)
            flags = torch.tensor([*raised, same], dtype=torch.float32)
            out[name] = sh.all_gather_cat(mesh, flags[None]).numpy()  # (ranks, 3)
    finally:
        tchol.check_cholesky_info = saved
    return out


WIDTHS = (2, 4, 3, 2, 4, 3)


def _widths(mesh, warmed):
    """The cohort update at the K of :data:`WIDTHS` (the warmed sessions
    repeated), each call beside its eager twin: per call the captures it
    made, the slices of the mesh's stage of ``v`` and whether the sessions
    equal the twins', from every rank."""
    update = sh.make_sharded_cohort_update(mesh)
    idx, y = torch.from_numpy(UPDATE["idx"]), torch.from_numpy(UPDATE["y"])
    rows = []
    for k in WIDTHS:
        take = [j % len(warmed) for j in range(k)]
        states, twins = ([_copy(warmed[j]) for j in take] for _ in range(2))
        c0 = graphs.captures()
        update(states, idx[take], y[take], y[take] != 0)
        captured = graphs.captures() - c0
        with graphs.eager():
            update(twins, idx[take], y[take], y[take] != 0)
        same = all(torch.equal(getattr(a, f), getattr(b, f)) and a.count == b.count
                   for a, b in zip(states, twins) for f in tgp.SESSION_FIELDS)
        (stage,) = [s for s in graphs.stages() if s.key[:2] == (mesh.uid, "v")]
        rows.append([captured, stage.buffer.shape[0], same])
    return sh.all_gather_cat(mesh, torch.tensor(rows, dtype=torch.float32)[None]).numpy()


def _rank_main(mesh, payload):
    """Every case on this mesh, eager and graphed; rank 0 keeps the results."""
    _stand_in()
    warmed, init = _shards(mesh, payload)
    cases = _factory_cases(mesh, payload, warmed, init)
    out = {"eager": {}, "graphed": {}, "captures": {}, "programs": {}}
    for name, fn in cases.items():
        with graphs.eager():
            out["eager"][name] = fn()
        c0 = graphs.captures()
        out["graphed"][name] = fn()
        c1 = graphs.captures()
        again = fn()
        out["captures"][name] = (c1 - c0, graphs.captures() - c1)
        assert all(np.array_equal(again[k], out["graphed"][name][k]) for k in again), name
    out["programs"] = sorted({p.name for p in graphs.programs() if p.mesh == mesh.uid})
    out["singles"], out["counts"] = _singles_and_counts(mesh, payload, warmed)
    out["checks"] = _failing_checks(mesh, warmed)
    out["widths"] = _widths(mesh, warmed)
    return out


def _payload(js):
    return {k: js[k] for k in ("n", "n_pad", "states", "state0", "density", "relevant",
                               "exclude", "sel_forbid", "users", "select_draws", "round_users")}


@pytest.fixture(scope="module")
def worlds(jax_side):
    """Each mesh size's results, from one spawned gloo world each."""
    return {p: launch(p, _rank_main, _payload(jax_side[p]), device="cpu") for p in MESHES}


# -- the programs against their eager calls and the reference --------------------


def _assert_equal(got, want, what):
    if isinstance(got, dict):
        assert got.keys() == want.keys(), what
        for k in got:
            _assert_equal(got[k], want[k], f"{what}.{k}")
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("factory", FACTORIES + ("production",))
@pytest.mark.parametrize("p", MESHES)
def test_a_graphed_mesh_program_equals_its_eager_call_bit_for_bit(worlds, p, factory):
    got = worlds[p]
    _assert_equal(got["graphed"][factory], got["eager"][factory], factory)


@pytest.mark.parametrize("factory", FACTORIES)
@pytest.mark.parametrize("p", MESHES)
def test_a_mesh_program_captures_once_per_signature_and_replays(worlds, p, factory):
    first, second = worlds[p]["captures"][factory]
    assert first >= 1 and second == 0, (first, second)


def test_every_mesh_program_is_held_by_its_mesh(worlds):
    assert worlds[2]["programs"] == sorted({
        "sharded_select", "sharded_absorb", "sharded_update", "sharded_set_query",
        "sharded_fit", "sharded_density", "sharded_session", "sharded_cohort",
        "sharded_cohort_select", "sharded_cohort_update"})


@pytest.mark.parametrize("factory", [f for f in FACTORIES if f not in ("select",
                                                                        "cohort_select")])
@pytest.mark.parametrize("p", MESHES)
def test_a_mesh_program_equals_the_reference(worlds, jax_side, p, factory):
    got, want = worlds[p]["graphed"][factory], jax_side[p]["jax"][factory]
    n = jax_side[p]["n"]
    for k, v in want.items():
        g = got[k]
        if k in ("batch", "counts"):
            np.testing.assert_array_equal(g, v, err_msg=k)
        elif k == "hyper":
            np.testing.assert_allclose(g, v, rtol=1e-4, err_msg=k)
        elif k in ("ap", "aps", "recall"):
            np.testing.assert_allclose(g, v, atol=AP_ATOL, err_msg=k)
        else:
            np.testing.assert_allclose(g[..., :n], np.asarray(v)[..., :n], atol=JAX_ATOL,
                                       rtol=1e-5, err_msg=k)
    if factory in ("session", "cohort"):
        assert not np.allclose(got["hyper"][..., 0], LS)  # the program re-learned


@pytest.mark.parametrize("strategy", STRATEGY_NAMES)
def test_the_stacked_mesh_cohort_select_equals_the_reference_and_k_single_selects(
        worlds, jax_side, strategy):
    """Mixed user models: session k selects with its own label and mistake
    probabilities and trade-off, as the reference's ``params_b``."""
    for p in MESHES:
        got = worlds[p]["graphed"]["cohort_select"][strategy]
        np.testing.assert_array_equal(got, worlds[p]["singles"][strategy], err_msg=str(p))
        np.testing.assert_array_equal(got[0], worlds[p]["graphed"]["select"][strategy])
        assert (got < jax_side[p]["n"]).all()
    np.testing.assert_array_equal(worlds[2]["graphed"]["cohort_select"][strategy],
                                  jax_side[2]["jax"]["cohort_select"][strategy])


@pytest.mark.parametrize("strategy", STRATEGY_NAMES)
@pytest.mark.parametrize("p", MESHES)
def test_a_cohort_selection_pays_its_collectives_once_for_the_cohort(worlds, p, strategy):
    counts = worlds[p]["counts"][strategy]
    assert len(set(counts.values())) == 1, counts
    assert counts[1] >= 1


@pytest.mark.parametrize("mode", ["graphed", "eager"])
@pytest.mark.parametrize("p", MESHES)
def test_a_failing_check_raises_on_every_rank_and_leaves_the_sessions(worlds, p, mode):
    flags = worlds[p]["checks"][mode]
    assert flags.shape == (p, 3)
    assert (flags == 1.0).all(), flags


@pytest.mark.parametrize("p", MESHES)
def test_every_rank_grows_and_binds_its_mesh_stages_alike(worlds, p):
    """Cohort updates of K = 2, 4, 3, 2, 4, 3: every rank captures, grows
    its stage and replays at the same calls, a K captures once after the
    growth to 4, and each call equals its eager twin."""
    rows = worlds[p]["widths"]  # (ranks, calls, (captures, stage slices, equal))
    assert rows.shape == (p, len(WIDTHS), 3) and (rows == rows[0]).all()
    captures, slices, same = rows[0].T
    assert list(captures[1:]) == [1, 1, 1, 0, 0] and list(slices[1:]) == [4] * 5
    assert (same == 1).all()


# -- a mesh of one, in-process ----------------------------------------------------


def _one_rank_state():
    ds = _dataset()
    st = tgp.gp_init(torch.from_numpy(ds.x), LS, VAR, NOISE, CAP)
    return tgp.gp_set_query(st, 4), torch.zeros(ds.n, dtype=torch.bool)


def test_a_mesh_of_one_replays_and_equals_its_eager_calls(stand_in):
    state, pad = _one_rank_state()
    with make_mesh(1, device="cpu") as mesh:
        st = sh.shard_state(state, mesh)
        select = sh.make_sharded_cohort_select(mesh, strategy="ital", batch_size=B, **PRODUCTION)
        params = StrategyParams.stack([_params(0), _params(1)])

        def call():
            gens = [torch.Generator().manual_seed(s) for s in (1, 2)]
            return select([_copy(st), _copy(st)], gens, pad, params)

        with graphs.eager():
            want = call()
        c0 = graphs.captures()
        got = call()
        assert graphs.captures() == c0 + 1
        torch.testing.assert_close(call(), got, rtol=0, atol=0)
        assert graphs.captures() == c0 + 1
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_a_closed_mesh_releases_its_programs_and_a_new_mesh_captures_anew(stand_in):
    state, pad = _one_rank_state()
    with make_mesh(1, device="cpu") as first:
        st = sh.shard_state(state, first)
        select = sh.make_sharded_select(first, strategy="ital", batch_size=B, **ITAL)
        c0 = graphs.captures()
        want = select(_copy(st), None, pad, _params(0))
        select(_copy(st), None, pad, _params(0))
        assert graphs.captures() == c0 + 1
        held = [p for p in graphs.programs() if p.mesh == first.uid]
        assert [p.name for p in held] == ["sharded_select"] and held[0].pinned[0] is st.x
    assert not [p for p in graphs.programs() if p.mesh == first.uid]
    assert held[0].graph is None and held[0].pinned == ()
    address = st.x.data_ptr()
    with make_mesh(1, device="cpu") as second:
        got = sh.make_sharded_select(second, strategy="ital", batch_size=B, **ITAL)(
            _copy(st), None, pad, _params(0))
        assert st.x.data_ptr() == address and graphs.captures() == c0 + 2
        assert [p.mesh for p in graphs.programs()] == [second.uid]
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_mesh_programs_keep_their_stacks_within_the_budget_of_their_own_mesh(stand_in,
                                                                              monkeypatch):
    """A mesh's stages count against the budget with its own mesh's only
    (every rank of a mesh sees the same calls), never beside a single-device
    program's, which rank 0 of a mesh service also holds; they grow with the
    K its calls ask for and go with the mesh."""
    state, pad = _one_rank_state()
    single = tgp.gp_session_copy(state)
    tgp.update_stacked([single, _copy(single)], torch.tensor([[7, 9]] * 2),
                       torch.ones(2, 2), torch.ones(2, 2, dtype=torch.bool))
    outside = [p for p in graphs.programs() if p.stacks]
    assert len(outside) == 1 and outside[0].mesh is None
    singles = graphs.stages()
    monkeypatch.setattr(graphs, "STACK_BYTES", sum(s.nbytes for s in singles))
    with make_mesh(1, device="cpu") as mesh:
        st = sh.shard_state(state, mesh)
        update = sh.make_sharded_cohort_update(mesh)
        for k in (2, 3):
            update([_copy(st) for _ in range(k)], torch.tensor([[7, 9]] * k),
                   torch.ones(k, 2), torch.ones(k, 2, dtype=torch.bool))
        mine = [p for p in graphs.programs() if p.mesh == mesh.uid]
        # K = 3 grew the mesh's stages past the budget, which released the
        # program of K = 2 and nothing of the single-device programs.
        assert [p.name for p in mine] == ["sharded_cohort_update"]
        assert mine[0].inputs["v"].shape[0] == 3
        assert all(s.key[0] == mesh.uid for s in mine[0].stages)
        assert sum(s.nbytes for s in mine[0].stages) > graphs.STACK_BYTES
        assert outside[0] in graphs.programs() and graphs.stages()[:len(singles)] == singles
    assert graphs.stages() == singles


# -- the mesh service -------------------------------------------------------------


def _toy_corpus(n_per=35, d=6, classes=3, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(classes, d)) * 4
    x = np.concatenate([c + rng.normal(size=(n_per, d)) for c in centers])
    return x.astype(np.float32)


def _label(i):
    return 1 if i < 35 else -1


def _stand_in_command(ctx):
    """A mesh command: every rank runs its programs on the stand-in graph."""
    _stand_in()


def _refuse_checks(ctx, on: bool):
    """A mesh command: every rank's Cholesky checks fail (``on``) or check,
    in the programs captured meanwhile."""
    if on:
        ctx.saved_check = tchol.check_cholesky_info
        tchol.check_cholesky_info = _refuse
    else:
        tchol.check_cholesky_info = ctx.saved_check


def _digests(ctx, sids):
    """Every rank's sums of each session's buffers, and its counts."""
    rows = [[float(getattr(ctx.sessions[s].state, f).double().sum()) for f in tgp.SESSION_FIELDS]
            + [float(ctx.sessions[s].state.count)] for s in sids]
    return sh.all_gather_cat(ctx.mesh, torch.tensor(rows, dtype=torch.float64)[None]).numpy()


def test_a_mesh_service_selects_a_mixed_user_model_group_as_one_program(stand_in,
                                                                         monkeypatch):
    """``/batch_select`` of sessions with different user models: one
    command, one program (captured once, replayed next round), the batches
    of one ``GET /batch`` per session; then a refused check in a feedback
    command fails the request on every rank alike, changes no session and
    leaves the mesh serving."""
    from ital_tpu_torch.parallel.interactive import MeshWorld
    from ital_tpu_torch.serve import RetrievalService

    base = dict(length_scale=2.5, noise=0.1, cap=24, strategy="ital", method_kwargs=PRODUCTION,
                corpus_name="toy")
    svc = RetrievalService(_toy_corpus(), **base, mesh_devices=2, device="cpu")
    try:
        svc._world.run(_stand_in_command)
        commands, names = [], []
        run, graphed = MeshWorld.run, graphs.run
        monkeypatch.setattr(MeshWorld, "run", lambda self, fn, *a: (
            commands.append(fn.__name__), run(self, fn, *a))[1])
        monkeypatch.setattr(graphs, "run", lambda name, *a, **kw: (
            names.append(name), graphed(name, *a, **kw))[1])
        users = [dict(label_prob=0.8, mistake_prob=0.1), dict(label_prob=0.95, mistake_prob=0.02),
                 dict(label_prob=0.8, mistake_prob=0.1)]
        cohort = [svc.create_session(**u) for u in users]
        twins = [svc.create_session(**u) for u in users]
        for j, (c, t) in enumerate(zip(cohort, twins)):
            for sid in (c, t):
                svc.set_query(sid, 5 + j)
                svc.feedback(sid, {str(i): _label(i) for i in (12, 40, 75, 99)})
        for rnd in range(2):
            commands.clear(), names.clear()
            c0 = graphs.captures()
            got = svc.next_batch_many(cohort, 3)
            assert commands == ["_mesh_cohort_select"] and names == ["sharded_cohort_select"]
            assert graphs.captures() == c0 + (1 if rnd == 0 else 0)
            alone = {t: svc.next_batch(t, 3) for t in twins}
            assert [got[c] for c in cohort] == [alone[t] for t in twins]
            for group, picks in ((cohort, got), (twins, alone)):
                svc.feedback_many({s: {str(i): _label(i) for i in picks[s]} for s in group})
        # Five labels pad to a block of 8: programs of their own, captured
        # with the refusing check.
        before = svc._world.run(_digests, cohort)
        svc._world.run(_refuse_checks, True)
        with pytest.raises(torch.linalg.LinAlgError, match="on purpose"):
            svc.feedback(cohort[0], {str(i): 1 for i in range(30, 35)})
        with pytest.raises(torch.linalg.LinAlgError, match="on purpose"):
            svc.feedback_many({s: {str(i): -1 for i in range(60, 65)} for s in cohort})
        svc._world.run(_refuse_checks, False)
        np.testing.assert_array_equal(svc._world.run(_digests, cohort), before)
        assert len(svc.next_batch(cohort[0], 3)) == 3  # the mesh still serves
    finally:
        svc.close()

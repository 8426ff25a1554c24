"""The port's fused sessions and cohorts on the mesh
(``ital_tpu_torch.parallel.sharded``: ``make_sharded_session``,
``make_sharded_cohort``, ``make_sharded_cohort_select`` / ``update``) against
``ital_tpu.parallel.sharded``'s and against the port's own per-round and
per-session paths, and the runner's ``query_batch`` / ``fused_sessions`` on
a mesh against its ``mesh_devices = 0`` run.

Each mesh is a gloo group of 2 or 4 CPU processes, started once for all the
cases of this file (:func:`worlds`), on a 105-row toy corpus, which pads to
106 and 108 rows.  The reference runs at the same mesh size on the
conftest's virtual CPU devices from the same warmed states, and its draws
(the users' uniforms from each round's ``fold_in`` key, the subsample
uniforms, the QMC shifts) reach the port through its seams.  AP curves agree
with the reference within 1e-5 and with the port's own paths exactly (the
runner's within 1e-6); batches are equal; ``mu`` and ``sig2`` agree with the
reference within 1e-5 (its f32 GP updates round otherwise) and a stacked
update with the single ones within 1e-6.  The user is noisy (label_prob 0.8,
mistake_prob 0.1), so MI scores stay clear of ties.

The spawned ranks import this module, so it imports neither ``jax`` nor
``ital_tpu`` at its top: the reference runs in the test bodies, in the
parent process.
"""

import json

import numpy as np
import pytest
import torch

from ital_tpu_torch import runner as trunner
from ital_tpu_torch.data.datasets import toy_gaussians
from ital_tpu_torch.models import gp as tgp
from ital_tpu_torch.models.hyperopt import LearnConfig
from ital_tpu_torch.parallel import launch, sharded as sh
from ital_tpu_torch.select.base import StrategyParams
from ital_tpu_torch.utils import config as tconfig

LS, VAR, NOISE, CAP = 1.5, 1.0, 0.1, 16
B = 2  # batch size
ROUNDS = 3
USER = dict(label_prob=0.8, mistake_prob=0.1)
QUERIES = (4, 60, 30, 90)  # the cohort takes the first K
MESHES = (2, 4)
JAX_ATOL, AP_ATOL = 1e-5, 1e-5
LEARN = dict(every=2, steps=10, lr=0.05)
SELECT_VARIANTS = {
    "scan": {"n_qmc": 32},
    "pool+refine": {"n_qmc": 16, "pool_size": 24, "refine_top": 8, "refine_n_qmc": 64},
    "subsample+qmc": {"n_qmc": 16, "subsample_size": 40, "randomize_qmc": True},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _dataset():
    return toy_gaussians(n_per_class=35, n_classes=3, dim=2, seed=5)  # 105 rows


# -- the reference's side, in the parent ----------------------------------------


def _jax_user_draws(key):
    """A round's user uniforms from its key, as the reference's round draws them."""
    import jax

    _, k_user = jax.random.split(key)
    k_label, k_flip = jax.random.split(k_user)
    return (np.asarray(jax.random.uniform(k_label, (B,))),
            np.asarray(jax.random.uniform(k_flip, (B,))))


def _jax_select_draws(key, n_pad):
    """A serving selection's draws (its key is the selection key itself)."""
    import jax
    import jax.numpy as jnp

    from ital_tpu.select import ital as jital

    return {"uniforms": np.asarray(jax.random.uniform(key, (n_pad,), jnp.float32)),
            "shifts": [np.asarray(jital._step_shift(key, t, jnp.float32)) for t in range(B)]}


def _jax_setup(p):
    """Warmed padded states, masks and the reference's runs at mesh size ``p``."""
    import jax
    import jax.numpy as jnp

    from ital_tpu.models import gp as jgp
    from ital_tpu.parallel import make_mesh as jmesh, pad_to_devices, shard_state
    from ital_tpu.parallel.sharded import (LearnConfig as JLearn, make_masks,
                                           make_sharded_cohort, make_sharded_session,
                                           shard_cohort_state)
    from ital_tpu.select.base import StrategyParams as JaxParams
    from tests.test_torch_gp import jax_state_arrays

    ds = _dataset()
    x_pad, n = pad_to_devices(ds.x, p)
    n_pad = x_pad.shape[0]
    mesh = jmesh(p)
    state0 = jgp.gp_init(jnp.asarray(x_pad), LS, VAR, NOISE, cap=CAP)
    params = JaxParams(label_prob=jnp.asarray(USER["label_prob"]),
                       mistake_prob=jnp.asarray(USER["mistake_prob"]))
    k = 4 if p == 4 else 2
    queries = QUERIES[:k]
    warmed, relevant, exclude = [], [], []
    sel_forbid, _ = make_masks(n_pad, n, queries[0])
    for q in queries:
        cls = int(ds.labels[q])
        # The query and four spread labels: distinct scores, no saturated MI.
        picks = [11 + q % 7, 40, 75, 99]
        ys = [1.0 if ds.relevance[i, cls] else -1.0 for i in picks]
        warmed.append(jgp.gp_update(jgp.gp_set_query(state0, jnp.asarray(q)),
                                    jnp.asarray(picks, jnp.int32), jnp.asarray(ys, jnp.float32),
                                    jnp.ones(len(picks), bool)))
        relevant.append(np.pad(ds.relevance[:, cls], (0, n_pad - n)))
        exclude.append(np.asarray(make_masks(n_pad, n, q)[1]))
    skeys = [jax.random.fold_in(jax.random.PRNGKey(3), i) for i in range(k)]
    users = [[_jax_user_draws(jax.random.fold_in(sk, r)) for r in range(ROUNDS)] for sk in skeys]
    out = {"n": n, "n_pad": n_pad, "states": [jax_state_arrays(w) for w in warmed],
           "relevant": np.stack(relevant), "exclude": np.stack(exclude),
           "sel_forbid": np.asarray(sel_forbid), "users": users, "queries": queries}

    kw = dict(strategy="ital", batch_size=B, n_rounds=ROUNDS, n_qmc=32)
    sess = make_sharded_session(mesh, **kw)
    st, aps = sess(shard_state(warmed[0], mesh), skeys[0], jnp.asarray(relevant[0]), sel_forbid,
                   jnp.asarray(exclude[0]), params)
    out["session"] = {"aps": np.asarray(aps), "mu": np.asarray(st.mu), "sig2": np.asarray(st.sig2)}
    learn = make_sharded_session(mesh, **kw, learn=JLearn(**LEARN))
    st, aps = learn(shard_state(warmed[0], mesh), skeys[0], jnp.asarray(relevant[0]), sel_forbid,
                    jnp.asarray(exclude[0]), params)
    out["session+learn"] = {"aps": np.asarray(aps), "hyper": [
        float(st.hyper.length_scale), float(st.hyper.var), float(st.hyper.noise)]}
    stateb = warmed[0].replace(**{f: jnp.stack([getattr(w, f) for w in warmed])
                                  for f in ("idx", "y", "valid", "count", "l", "beta", "v",
                                            "mu", "sig2")})
    cohort = make_sharded_cohort(mesh, **kw)
    stb, aps = cohort(shard_cohort_state(stateb, mesh), jnp.stack(skeys),
                      jnp.asarray(np.stack(relevant)), sel_forbid,
                      jnp.asarray(np.stack(exclude)), params)
    out["cohort"] = {"aps": np.asarray(aps), "mu": np.asarray(stb.mu)}
    if p == 2:
        out.update(_jax_serving(mesh, warmed, skeys, sel_forbid, params, n_pad))
    return out


def _jax_serving(mesh, warmed, skeys, sel_forbid, params, n_pad):
    """The reference's serving cohort select (each variant) and update."""
    import jax
    import jax.numpy as jnp

    from ital_tpu.parallel import shard_state
    from ital_tpu.parallel.sharded import make_sharded_cohort_select, make_sharded_cohort_update

    states = tuple(shard_state(w, mesh) for w in warmed)
    params_b = jax.tree.map(lambda *ls: jnp.stack(ls), *[params] * len(states))
    out = {"select_draws": [_jax_select_draws(k, n_pad) for k in skeys], "select": {}}
    for name, opts in SELECT_VARIANTS.items():
        fn = make_sharded_cohort_select(mesh, strategy="ital", batch_size=B, **opts)
        out["select"][name] = np.asarray(fn(states, jnp.stack(skeys), sel_forbid, params_b))
    idx = np.asarray([[7, 50, 88, 0], [20, 101, 3, 0]], np.int32)
    y = np.asarray([[1.0, -1.0, 1.0, 0.0], [-1.0, 1.0, 1.0, 0.0]], np.float32)
    new, counts = make_sharded_cohort_update(mesh)(states, jnp.asarray(idx), jnp.asarray(y),
                                                   jnp.asarray(y != 0))
    out["update"] = {"idx": idx, "y": y, "counts": np.asarray(counts),
                     "mu": np.stack([np.asarray(s.mu) for s in new]),
                     "sig2": np.stack([np.asarray(s.sig2) for s in new])}
    return out


@pytest.fixture(scope="module")
def jax_side():
    return {p: _jax_setup(p) for p in MESHES}


# -- the port's side, on every rank of a gloo mesh --------------------------------


def _params():
    return StrategyParams.create("cpu", **USER)


def _draws(users, k):
    return [(None, torch.from_numpy(users[k][r][0]), torch.from_numpy(users[k][r][1]))
            for r in range(ROUNDS)]


class _Counted:
    """Counts the mesh's collective calls (the sums, the gathers and the ring)
    while it is entered."""

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


def _rank_main(mesh, payload):
    """Every case on this mesh; rank 0 keeps the results."""
    states = [tgp.state_from_arrays(a, "cpu") for a in payload["states"]]
    k = len(states)
    rel = torch.from_numpy(payload["relevant"])
    exc = torch.from_numpy(payload["exclude"])
    pad = torch.from_numpy(payload["sel_forbid"])
    users = payload["users"]
    kw = dict(strategy="ital", batch_size=B, n_rounds=ROUNDS, n_qmc=32)
    out = {}

    def gathered(st):
        return {"mu": sh.gather_mu(mesh, st.mu).numpy(), "sig2": sh.gather_mu(mesh, st.sig2).numpy()}

    # The fused session, and the per-round path it must repeat.
    sess = sh.make_sharded_session(mesh, **kw)
    st, aps = sess(sh.shard_state(states[0], mesh), _draws(users, 0), rel[0], pad, exc[0], _params())
    out["session"] = {"aps": aps.numpy(), **gathered(st)}
    round_fn = sh.make_sharded_round(mesh, strategy="ital", batch_size=B, n_qmc=32)
    st = sh.shard_state(states[0], mesh)
    curve = []
    for draws in _draws(users, 0):
        st, _, ap, _ = round_fn(st, *draws, rel[0], pad, exc[0], _params())
        curve.append(float(ap))
    out["per_round"] = np.asarray(curve)
    learn = sh.make_sharded_session(mesh, **kw, learn=LearnConfig(**LEARN))
    st, aps = learn(sh.shard_state(states[0], mesh), _draws(users, 0), rel[0], pad, exc[0],
                    _params())
    out["session+learn"] = {"aps": aps.numpy(), "hyper": [
        float(st.hyper.length_scale), float(st.hyper.var), float(st.hyper.noise)]}

    # The cohort, and each of its sessions fused alone.
    cohort = sh.make_sharded_cohort(mesh, **kw)
    draws = [([None] * k, torch.stack([torch.from_numpy(users[j][r][0]) for j in range(k)]),
              torch.stack([torch.from_numpy(users[j][r][1]) for j in range(k)]))
             for r in range(ROUNDS)]
    stb, aps = cohort(sh.shard_cohort_state(tgp.stack_states(states), mesh), draws, rel, pad,
                      exc, _params())
    out["cohort"] = {"aps": aps.numpy(), "mu": sh.gather_mu(mesh, stb.mu).numpy(),
                     "alone": np.stack([
                         sess(sh.shard_state(states[j], mesh), _draws(users, j), rel[j], pad,
                              exc[j], _params())[1].numpy() for j in range(k)])}
    # The collectives of one cohort round, at K = 1, 2 (and 4 on the 4-rank mesh).
    one_round = {name: sh.make_sharded_cohort(mesh, strategy="ital", batch_size=B, n_rounds=1,
                                              **opts)
                 for name, opts in SELECT_VARIANTS.items()}
    counts = {}
    for name, fn in one_round.items():
        for kk in sorted({1, 2, k}):
            gens = [torch.Generator().manual_seed(j) for j in range(kk)]
            with _Counted() as c:
                fn(sh.shard_cohort_state(tgp.stack_states(states[:kk]), mesh),
                   [(gens, draws[0][1][:kk], draws[0][2][:kk])], rel[:kk], pad, exc[:kk],
                   _params())
            counts[(name, kk)] = c.calls
    out["counts"] = counts
    if "select_draws" in payload:
        out.update(_rank_serving(mesh, payload, states, pad))
    return out


def _rank_serving(mesh, payload, states, pad):
    """The serving cohort programs against K single sharded calls."""
    out = {"select": {}, "select_alone": {}}
    d = payload["select_draws"]
    k = len(states)
    for name, opts in SELECT_VARIANTS.items():
        fed = {}
        if opts.get("subsample_size"):
            fed["subsample_uniforms"] = torch.stack([torch.from_numpy(x["uniforms"]) for x in d])
        if opts.get("randomize_qmc"):
            fed["qmc_shifts"] = [torch.stack([torch.from_numpy(x["shifts"][t]) for x in d])
                                 for t in range(B)]
        sel = sh.make_sharded_cohort_select(mesh, strategy="ital", batch_size=B, **opts)
        st = sh.shard_cohort_state(tgp.stack_states(states), mesh)
        out["select"][name] = sel(st, [None] * k, pad, _params(), **fed).numpy()
        one = sh.make_sharded_select(mesh, strategy="ital", batch_size=B, **opts)
        out["select_alone"][name] = np.stack([one(
            sh.shard_state(states[j], mesh), None, pad, _params(),
            **{f: (v[j] if f == "subsample_uniforms" else [s[j] for s in v])
               for f, v in fed.items()}).numpy() for j in range(k)])
    u = payload["update"]
    idx, y = torch.from_numpy(u["idx"]).long(), torch.from_numpy(u["y"])
    shards = [sh.shard_state(s, mesh) for s in states]
    st = tgp.stack_states(shards)
    sh.make_sharded_cohort_update(mesh)(st, idx, y, y != 0)
    tgp.unstack_into(st, shards)
    alone = [sh.make_sharded_update(mesh)(sh.shard_state(states[j], mesh), idx[j], y[j], y[j] != 0)
             for j in range(k)]
    out["update"] = {
        "counts": [s.count for s in shards],
        "mu": np.stack([sh.gather_mu(mesh, s.mu).numpy() for s in shards]),
        "sig2": np.stack([sh.gather_mu(mesh, s.sig2).numpy() for s in shards]),
        "mu_alone": np.stack([sh.gather_mu(mesh, s.mu).numpy() for s in alone]),
    }
    return out


@pytest.fixture(scope="module")
def worlds(jax_side):
    """Each mesh size's results, from one spawned gloo world each."""
    return {p: launch(p, _rank_main, jax_side[p], device="cpu") for p in MESHES}


# -- the programs against the reference and against the port's own paths --------


@pytest.mark.parametrize("p", MESHES)
def test_fused_session_equals_jax_and_the_per_round_path(worlds, jax_side, p):
    got, want = worlds[p], jax_side[p]
    n = want["n"]
    np.testing.assert_array_equal(got["session"]["aps"], got["per_round"])
    np.testing.assert_allclose(got["session"]["aps"], want["session"]["aps"], atol=AP_ATOL)
    for f in ("mu", "sig2"):
        np.testing.assert_allclose(got["session"][f][:n], want["session"][f][:n], atol=JAX_ATOL,
                                   err_msg=f)


@pytest.mark.parametrize("p", MESHES)
def test_relearn_inside_the_fused_loop_equals_jax(worlds, jax_side, p):
    """After round 2 the session re-learns from the gathered labels (rank 0's
    fit on every rank) and refits; the curves and the learned values are
    the reference's."""
    got, want = worlds[p]["session+learn"], jax_side[p]["session+learn"]
    np.testing.assert_allclose(got["aps"], want["aps"], atol=AP_ATOL)
    np.testing.assert_allclose(got["hyper"], want["hyper"], rtol=1e-4)
    assert got["hyper"][0] != LS


@pytest.mark.parametrize("p", MESHES)
def test_cohort_equals_jax_and_each_session_alone(worlds, jax_side, p):
    got, want = worlds[p]["cohort"], jax_side[p]["cohort"]
    n = jax_side[p]["n"]
    assert got["aps"].shape == (len(jax_side[p]["queries"]), ROUNDS)
    np.testing.assert_array_equal(got["aps"], got["alone"])
    np.testing.assert_allclose(got["aps"], want["aps"], atol=AP_ATOL)
    np.testing.assert_allclose(got["mu"][:, :n], want["mu"][:, :n], atol=JAX_ATOL)


@pytest.mark.parametrize("variant", list(SELECT_VARIANTS))
def test_cohort_select_equals_jax_and_k_single_selects(worlds, jax_side, variant):
    got = worlds[2]
    np.testing.assert_array_equal(got["select"][variant], jax_side[2]["select"][variant])
    np.testing.assert_array_equal(got["select"][variant], got["select_alone"][variant])
    assert (got["select"][variant] < jax_side[2]["n"]).all()


def test_cohort_update_equals_jax_and_k_single_updates(worlds, jax_side):
    got, want = worlds[2]["update"], jax_side[2]["update"]
    n = jax_side[2]["n"]
    assert got["counts"] == [int(c) for c in want["counts"]] == [9, 9]
    # A stack's batched factor algebra rounds apart from one session's (f32).
    np.testing.assert_allclose(got["mu"], got["mu_alone"], atol=1e-6, rtol=0)
    for f in ("mu", "sig2"):
        np.testing.assert_allclose(got[f][:, :n], want[f][:, :n], atol=JAX_ATOL, err_msg=f)


@pytest.mark.parametrize("variant", list(SELECT_VARIANTS))
@pytest.mark.parametrize("p", MESHES)
def test_a_cohort_round_pays_its_collectives_once_for_the_cohort(worlds, p, variant):
    counts = {kk: c for (name, kk), c in worlds[p]["counts"].items() if name == variant}
    assert len(set(counts.values())) == 1, counts
    assert min(counts) == 1 and max(counts) == (4 if p == 4 else 2)


# -- the runner: query_batch and fused_sessions on a mesh --------------------------


def _cfg(mesh=0, gp=None, **kw):
    base = dict(
        dataset="toy", dataset_kwargs=dict(n_per_class=35, n_classes=3, dim=2, seed=0),
        method="ital", batch_size=2, n_rounds=3, repetitions=1, queries_per_class=2,
        max_classes=2, seed=0, mesh_devices=mesh,
        gp=tconfig.GPConfig(**{"length_scale": 1.5, "var": 1.0, "noise": 0.1, "cap": 16,
                               **(gp or {})}),
        user=tconfig.UserConfig(**USER), method_kwargs={"n_qmc": 32},
    )
    base.update(kw)
    return tconfig.ExperimentConfig(**base)


RUNNER_CASES = {
    "query_batch": (2, {"query_batch": 2}),
    "fused": (2, {"fused_sessions": True}),
    "query_batch+fused+learn": (2, {"query_batch": 3, "fused_sessions": True,
                                    "gp": {"learn_every": 2, "learn_steps": 10}}),
    "query_batch+pool+qmc": (2, {"query_batch": 2, "method_kwargs": {
        "n_qmc": 16, "pool_size": 30, "refine_top": 8, "refine_n_qmc": 64,
        "randomize_qmc": True}}),
    "query_batch:4": (4, {"query_batch": 4}),
    "fused:emoc": (2, {"fused_sessions": True, "method": "emoc", "method_kwargs": {}}),
}


@pytest.mark.parametrize("case", list(RUNNER_CASES))
def test_runner_on_a_mesh_gives_the_single_device_curves(case, tmp_path):
    mesh, change = RUNNER_CASES[case]
    log = tmp_path / "mesh.jsonl"
    got = trunner.run_experiment(_cfg(mesh, log_jsonl=str(log), **change), device="cpu")
    want = trunner.run_experiment(_cfg(0, **change), device="cpu")
    # The shards' blocks round apart from the whole corpus' (f32 AP: 1e-6).
    np.testing.assert_allclose(got["ap"], want["ap"], atol=1e-6, rtol=0)
    assert got["mesh_devices"] == mesh and got["fused"] is True and got["update_ms"] == 0.0
    assert got.get("query_batch") == change.get("query_batch")
    rows = [json.loads(line) for line in log.read_text().splitlines()]
    assert len(rows) == 4 and all(r["sharded"] == mesh and len(r["ap_curve"]) == 3 for r in rows)
    assert all(("cohort_ms" if "query_batch" in change else "session_ms") in r for r in rows)


def test_runner_mesh_messages_and_the_replicated_factor_past_the_threshold(capsys):
    got = trunner.run_experiment(_cfg(2, query_batch=2, gp={"chol2d_threshold": 16,
                                                            "refit_every": 1}), device="cpu")
    out = capsys.readouterr().out
    assert "# sharded cohorts run fused" in out
    assert "GP.refit_every is a serial/per-round-sharded feature" in out
    assert "# WARNING: cap=16 crossed chol2d_threshold=16" in out
    assert ("Unset fused_sessions/query_batch to enable the distributed refit "
            "(parallel/bigcap.py), or raise GP.chol2d_threshold to silence this.") in out
    want = trunner.run_experiment(_cfg(0, query_batch=2), device="cpu")
    np.testing.assert_array_equal(got["ap"], want["ap"])

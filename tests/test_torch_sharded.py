"""The port's corpus-sharded round (``ital_tpu_torch.parallel``) against
``ital_tpu.parallel`` and against the port's own single-device round.

Each mesh is a gloo group of 2 or 4 CPU processes, started once for all the
cases of this file (:func:`worlds`), on a 225-row toy corpus, which pads to
226 and 228 rows.  The reference runs ``make_sharded_round`` at the same mesh
size on the conftest's virtual CPU devices, from the same warmed state, and
its draws (the user's uniforms, the subsample and ``random`` uniforms, the
QMC shifts) are fed to the port through its seams.  Batches are equal;
``mu`` and ``sig2`` agree with the port's single-device round within 1e-6
in f32 and 1e-12 in f64, and with the reference within 1e-5 (the two
packages' f32 GP updates round apart); AP within 1e-6.

The spawned ranks import this module, so it imports neither ``jax`` nor
``ital_tpu`` at its top: the reference runs in the test bodies, in the
parent process.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ital_tpu_torch.data.datasets import toy_gaussians
from ital_tpu_torch.models import gp as tgp
from ital_tpu_torch.ops.kernels import blockwise_reduce_abs_kpost
from ital_tpu_torch.parallel import launch, make_mesh, sharded as sh
from ital_tpu_torch.parallel.launch import RankFailed
from ital_tpu_torch.parallel.ring import ring_reduce_over_corpus
from ital_tpu_torch.select import STRATEGIES, baselines, get_strategy, ital as tital
from ital_tpu_torch.select.base import StrategyParams
from ital_tpu_torch.data.user import feedback_from_uniforms
from ital_tpu_torch.utils.metrics import average_precision, top_k_stable

LS, VAR, NOISE, CAP = 1.5, 1.0, 0.1, 16
B = 2  # batch size
QUERY = 4
USER = dict(label_prob=0.9, mistake_prob=0.05)
DENSITY = {"sud", "tcal", "adapt_al"}
MESHES = (2, 4)
# mu and sig2 against the port's single-device round (f32, f64), against
# the reference (its f32 GP update rounds otherwise: 1e-5, as the port's
# update is held to ``jax.vmap(gp_update)`` in test_torch_cohort.py), and AP.
F32_ATOL, F64_ATOL, JAX_ATOL, AP_ATOL = 1e-6, 1e-12, 1e-5, 1e-6
STRATEGY_NAMES = sorted(STRATEGIES)
F64_STRATEGIES = ("uncertainty_sampling", "emoc")
VARIANTS = {
    "pool": {"n_qmc": 32, "pool_size": 24},
    "refine": {"n_qmc": 16, "refine_top": 12, "refine_n_qmc": 64},
    "pool+refine": {"n_qmc": 16, "pool_size": 24, "refine_top": 8, "refine_n_qmc": 64},
    "subsample": {"n_qmc": 32, "subsample_size": 40},
    "qmc": {"n_qmc": 16, "randomize_qmc": True},
    "qmc+pool+refine": {"n_qmc": 16, "pool_size": 24, "refine_top": 8, "refine_n_qmc": 64,
                        "randomize_qmc": True},
    "block": {"n_qmc": 16, "block": 16, "pool_size": 24, "refine_top": 8, "refine_n_qmc": 64},
}


def _cases():
    out = [(s, s, {"n_qmc": 32} if s == "ital" else {}) for s in STRATEGY_NAMES]
    return out + [(f"ital:{v}", "ital", kw) for v, kw in VARIANTS.items()]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _dataset():
    return toy_gaussians(n_per_class=75, n_classes=3, dim=2, seed=5)  # 225 rows


# -- the reference's side, in the parent ----------------------------------------


def _jax_setup(p):
    """The warmed padded state, masks, draws and the reference's density at
    mesh size ``p``, as JAX arrays."""
    import jax
    import jax.numpy as jnp

    from ital_tpu.models import gp as jgp
    from ital_tpu.parallel import make_mesh as jmesh, pad_to_devices, shard_state
    from ital_tpu.parallel.sharded import make_masks, make_sharded_density
    from ital_tpu.select import ital as jital

    ds = _dataset()
    x_pad, n = pad_to_devices(ds.x, p)
    n_pad = x_pad.shape[0]
    mesh = jmesh(p)
    state0 = jgp.gp_init(jnp.asarray(x_pad), LS, VAR, NOISE, cap=CAP)
    cls = int(ds.labels[QUERY])
    # A query and ten spread labels: distinct scores, no saturated-MI ties.
    picks = list(range(5, ds.n, 24))
    ys = [1.0 if ds.relevance[i, cls] else -1.0 for i in picks]
    warm = jgp.gp_update(jgp.gp_set_query(state0, jnp.asarray(QUERY)),
                         jnp.asarray(picks, jnp.int32), jnp.asarray(ys, jnp.float32),
                         jnp.ones(len(picks), bool))
    relevant = np.pad(ds.relevance[:, cls], (0, n_pad - n))
    sel_forbid, ap_exclude = make_masks(n_pad, n, QUERY)
    density = make_sharded_density(mesh)(shard_state(state0, mesh), sel_forbid)
    key = jax.random.PRNGKey(7)
    k_sel, k_user = jax.random.split(key)
    k_label, k_flip = jax.random.split(k_user)
    draws = {
        "u_label": np.asarray(jax.random.uniform(k_label, (B,))),
        "u_flip": np.asarray(jax.random.uniform(k_flip, (B,))),
        "uniforms": np.asarray(jax.random.uniform(k_sel, (n_pad,), jnp.float32)),
        "shifts": [np.asarray(jital._step_shift(k_sel, t, jnp.float32)) for t in range(B)],
    }
    return dict(mesh=mesh, key=key, warm=warm, density=density, relevant=relevant,
                sel_forbid=sel_forbid, ap_exclude=ap_exclude, draws=draws, n=n)


@pytest.fixture(scope="module")
def jax_side():
    return {p: _jax_setup(p) for p in MESHES}


def _jax_round(js, strategy, opts):
    import jax.numpy as jnp

    from ital_tpu.parallel import make_sharded_round, shard_state
    from ital_tpu.select.base import StrategyParams as JaxParams

    state = js["warm"]
    if strategy in DENSITY:
        state = state.replace(density=js["density"])
    params = JaxParams(label_prob=jnp.asarray(USER["label_prob"]),
                       mistake_prob=jnp.asarray(USER["mistake_prob"]))
    fn = make_sharded_round(js["mesh"], strategy=strategy, batch_size=B, **opts)
    out, batch, ap, _ = fn(shard_state(state, js["mesh"]), js["key"],
                           jnp.asarray(js["relevant"]), js["sel_forbid"], js["ap_exclude"],
                           params)
    return {"batch": np.asarray(batch), "ap": float(ap), "mu": np.asarray(out.mu),
            "sig2": np.asarray(out.sig2)}


def _payload(js):
    from tests.test_torch_gp import jax_state_arrays

    return {
        "state": jax_state_arrays(js["warm"]), "density": np.asarray(js["density"]),
        "relevant": js["relevant"], "sel_forbid": np.asarray(js["sel_forbid"]),
        "ap_exclude": np.asarray(js["ap_exclude"]), "draws": js["draws"], "n": js["n"],
        "cases": _cases(),
    }


# -- the port's side, on every rank of a gloo mesh --------------------------------


def _params(device="cpu"):
    return StrategyParams.create(device, **USER)


def _fed(strategy, opts, draws, n_pad):
    """The reference's draws for one case, through the port's seams."""
    u = torch.tensor(draws["uniforms"][:n_pad])
    fed = {}
    if strategy == "random":
        fed["uniforms"] = u
    if opts.get("subsample_size"):
        fed["subsample_uniforms"] = u
    if opts.get("randomize_qmc"):
        fed["qmc_shifts"] = [torch.tensor(s) for s in draws["shifts"]]
    return fed


def _as_f64(state):
    return dataclasses.replace(
        state, **{f: getattr(state, f).double() for f in ("x", "y", "l", "beta", "v", "mu", "sig2",
                                                         "x2")},
        hyper=tgp.GPHyper(**{f: getattr(state.hyper, f).double()
                             for f in ("length_scale", "var", "noise")}))


def _gathered(mesh, state):
    return {f: sh.all_gather_cat(mesh, getattr(state, f)).numpy() for f in ("mu", "sig2")}


def _rank_cases(mesh, payload):
    """Every case's sharded round from the shared state; rank 0 keeps the results."""
    full = tgp.state_from_arrays(payload["state"], "cpu")
    with_density = dataclasses.replace(full, density=torch.from_numpy(payload["density"]))
    masks = [torch.from_numpy(payload[k]) for k in ("relevant", "sel_forbid", "ap_exclude")]
    d = payload["draws"]
    users = torch.from_numpy(d["u_label"]), torch.from_numpy(d["u_flip"])
    n_pad = masks[0].shape[0]
    out = {}
    for name, strategy, opts in payload["cases"]:
        state = sh.shard_state(with_density if strategy in DENSITY else full, mesh)
        round_fn = sh.make_sharded_round(mesh, strategy=strategy, batch_size=B, recall_ks=(10,),
                                         **opts)
        state, batch, ap, recalls = round_fn(state, None, *users, *masks, _params(),
                                             **_fed(strategy, opts, d, n_pad))
        out[name] = {"batch": batch.numpy(), "ap": float(ap), "recall": float(recalls[0]),
                     **_gathered(mesh, state)}
    # f64 (the port's selection takes f32 user-model tables, so ITAL stays f32).
    for strategy in F64_STRATEGIES:
        round_fn = sh.make_sharded_round(mesh, strategy=strategy, batch_size=B)
        state, batch, ap, _ = round_fn(sh.shard_state(_as_f64(full), mesh), None, *users, *masks,
                                       _params())
        out[f"f64:{strategy}"] = {"batch": batch.numpy(), "ap": float(ap), **_gathered(mesh, state)}
    return out


def _rank_parts(mesh, payload):
    """The collective helpers, the ring, the density, the ring scores and
    the update entry points on this mesh."""
    out = {}
    full = tgp.state_from_arrays(payload["state"], "cpu")
    n_pad = full.x.shape[0]
    lo, hi = mesh.rank * (n_pad // mesh.size), (mesh.rank + 1) * (n_pad // mesh.size)
    # Argmax and top-k over vectors full of ties, some across shard edges.
    rng = np.random.default_rng(3)
    vecs = [np.floor(rng.random(n_pad) * 3).astype(np.float32) for _ in range(4)]
    vecs[0][:] = 1.0
    vecs[1][[n_pad - 1, 1]] = 9.0
    vecs[2][rng.random(n_pad) < 0.3] = -np.inf
    out["argmax"] = [int(sh.global_argmax(mesh, torch.from_numpy(v[lo:hi]))) for v in vecs]
    out["topk"] = []
    for v in vecs:
        gidx, forbid = sh._sharded_pool_indices(mesh, torch.from_numpy(v[lo:hi]), 50, 52)
        out["topk"].append((gidx.numpy(), forbid.numpy()))
    out["vecs"] = vecs
    # The ring's visiting order, from every rank.
    order = ring_reduce_over_corpus(mesh, [torch.tensor([mesh.rank])],
                                    lambda acc, blk: acc + [int(blk[0][0])], [])
    out["ring_order"] = sh.all_gather_cat(mesh, torch.tensor(order)).view(mesh.size, -1).numpy()
    # The corpus density over the real rows, and the ring scores.
    state = sh.shard_state(full, mesh)
    pad = torch.from_numpy(payload["sel_forbid"])
    dens = sh.make_sharded_density(mesh)(sh.shard_state(tgp.gp_init(full.x, LS, VAR, NOISE, CAP),
                                                        mesh), pad)
    out["density"] = sh.all_gather_cat(mesh, dens).numpy()
    valid = 1.0 - pad[lo:hi].float()
    for name, fn in (("emoc", sh._sharded_emoc_scores), ("mcmi_min", sh._sharded_mcmi_scores)):
        out[name] = sh.all_gather_cat(mesh, fn(mesh, state, valid)).numpy()
    # set_query, update and fit through their mesh entry points.
    state = sh.make_sharded_set_query(mesh)(state, 100)
    out["set_query"] = _gathered(mesh, state)
    idx = torch.tensor([7, 150, 224, 33])
    state = sh.make_sharded_update(mesh)(state, idx, torch.tensor([1.0, -1.0, 1.0, 1.0]),
                                         torch.tensor([True, True, False, True]))
    out["update"] = _gathered(mesh, state)
    state.hyper.length_scale = torch.tensor(2.0)
    out["fit"] = _gathered(mesh, sh.make_sharded_fit(mesh)(state))
    return out


def _rank_main(mesh, payload):
    return {"cases": _rank_cases(mesh, payload), "parts": _rank_parts(mesh, payload)}


@pytest.fixture(scope="module")
def worlds(jax_side):
    """Each mesh size's results, from one spawned gloo world each."""
    return {p: launch(p, _rank_main, _payload(jax_side[p]), device="cpu") for p in MESHES}


# -- the port's single-device round, in the parent ------------------------------


def _serial_round(payload, strategy, opts, *, dtype=torch.float32):
    """The port's single-device round on the real rows, with the same draws."""
    arrays = dict(payload["state"])
    n = payload["n"]
    for f in ("x", "x2", "mu", "sig2"):
        arrays[f] = arrays[f][:n]
    arrays["v"] = arrays["v"][:, :n]
    state = tgp.state_from_arrays(arrays, "cpu")
    if dtype == torch.float64:
        state = _as_f64(state)
    if strategy in DENSITY:
        state.density = torch.tensor(payload["density"][:n])
    d = payload["draws"]
    fed = _fed(strategy, opts, d, n)
    params = _params()
    if strategy == "random":
        batch = baselines.random_from_uniforms(state, B, fed["uniforms"])
    else:
        batch = get_strategy(strategy)(state, B, None, params, **opts, **fed)
    relevant = torch.from_numpy(payload["relevant"][:n])
    y, valid = feedback_from_uniforms(torch.tensor(d["u_label"]), torch.tensor(d["u_flip"]),
                                      batch, relevant, params.label_prob, params.mistake_prob)
    state = tgp.gp_update(state, batch, y, valid)
    exclude = torch.zeros(n, dtype=torch.bool)
    exclude[QUERY] = True
    return {"batch": batch.numpy(), "ap": float(average_precision(state.mu, relevant, exclude)),
            "mu": state.mu.numpy(), "sig2": state.sig2.numpy()}


def _assert_round(got, want, n, atol, what=""):
    np.testing.assert_array_equal(got["batch"], want["batch"], err_msg=what)
    assert (got["batch"] < n).all(), what
    for f in ("mu", "sig2"):
        np.testing.assert_allclose(got[f][:n], want[f][:n], rtol=0, atol=atol, err_msg=f"{what} {f}")
    assert abs(got["ap"] - want["ap"]) <= AP_ATOL, what


@pytest.mark.parametrize("strategy", STRATEGY_NAMES)
@pytest.mark.parametrize("p", MESHES)
def test_every_strategy_sharded_equals_jax_and_the_single_device_round(worlds, jax_side, p,
                                                                       strategy):
    js = jax_side[p]
    got = worlds[p]["cases"][strategy]
    opts = {"n_qmc": 32} if strategy == "ital" else {}
    _assert_round(got, _jax_round(js, strategy, opts), js["n"], JAX_ATOL, "jax")
    _assert_round(got, _serial_round(_payload(js), strategy, opts), js["n"], F32_ATOL, "single")
    assert 0.0 <= got["recall"] <= 1.0


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("p", MESHES)
def test_ital_modes_sharded_equal_jax_and_the_single_device_round(worlds, jax_side, p, variant):
    js = jax_side[p]
    got = worlds[p]["cases"][f"ital:{variant}"]
    opts = VARIANTS[variant]
    _assert_round(got, _jax_round(js, "ital", opts), js["n"], JAX_ATOL, "jax")
    _assert_round(got, _serial_round(_payload(js), "ital", opts), js["n"], F32_ATOL, "single")


@pytest.mark.parametrize("strategy", F64_STRATEGIES)
@pytest.mark.parametrize("p", MESHES)
def test_f64_round_equals_the_single_device_round(worlds, jax_side, p, strategy):
    js = jax_side[p]
    want = _serial_round(_payload(js), strategy, {}, dtype=torch.float64)
    _assert_round(worlds[p]["cases"][f"f64:{strategy}"], want, js["n"], F64_ATOL)


@pytest.mark.parametrize("p", MESHES)
def test_argmax_and_pool_top_k_break_ties_to_the_lowest_global_index(worlds, p):
    parts = worlds[p]["parts"]
    for v, got in zip(parts["vecs"], parts["argmax"]):
        assert got == int(np.argmax(v))
    for v, (gidx, forbid) in zip(parts["vecs"], parts["topk"]):
        vals, want = top_k_stable(torch.from_numpy(v), 50)
        np.testing.assert_array_equal(gidx[:50], want.numpy())
        np.testing.assert_array_equal(forbid[:50], ~np.isfinite(vals.numpy()))
        assert forbid[50:].all()  # the pool's pad slots


@pytest.mark.parametrize("p", MESHES)
def test_ring_visits_rank_me_plus_s_at_step_s(worlds, p):
    want = (np.arange(p)[:, None] + np.arange(p)[None, :]) % p
    np.testing.assert_array_equal(worlds[p]["parts"]["ring_order"], want)


@pytest.mark.parametrize("p", MESHES)
def test_sharded_density_equals_the_single_device_density_and_jax(worlds, jax_side, p):
    js = jax_side[p]
    n = js["n"]
    ds = _dataset()
    single = tgp.corpus_density(tgp.gp_init(torch.from_numpy(ds.x), LS, VAR, NOISE, CAP))
    got = worlds[p]["parts"]["density"]
    np.testing.assert_allclose(got[:n], single.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[:n], np.asarray(js["density"])[:n], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("strategy", ["emoc", "mcmi_min"])
@pytest.mark.parametrize("p", MESHES)
def test_ring_scores_equal_a_mesh_of_one(worlds, jax_side, p, strategy):
    """The p-rank ring sums in another order than one rank: rtol 1e-5; EMOC
    also against the single-device blockwise reduction weighted off the
    pad rows."""
    payload = _payload(jax_side[p])
    full = tgp.state_from_arrays(payload["state"], "cpu")
    valid = 1.0 - torch.tensor(payload["sel_forbid"]).float()
    with make_mesh(1, device="cpu") as mesh:
        one = (sh._sharded_emoc_scores if strategy == "emoc" else sh._sharded_mcmi_scores)(
            mesh, sh.shard_state(full, mesh), valid)
    got = worlds[p]["parts"][strategy]
    np.testing.assert_allclose(got, one.numpy(), rtol=1e-5, atol=1e-6)
    if strategy == "emoc":
        colabs = blockwise_reduce_abs_kpost(full.x, full.v, torch.arange(full.x.shape[0]), LS, VAR,
                                            weights=valid, x2=full.x2)
        want = baselines.emoc_scores_from_moments(full.mu, full.sig2, full.hyper.noise, colabs)
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("p", MESHES)
def test_set_query_update_and_fit_entry_points_equal_the_single_device_ones(worlds, jax_side, p):
    payload = _payload(jax_side[p])
    st = tgp.gp_set_query(tgp.state_from_arrays(payload["state"], "cpu"), 100)
    parts = worlds[p]["parts"]
    want = {"set_query": (st.mu.clone(), st.sig2.clone())}
    tgp.gp_update(st, torch.tensor([7, 150, 224, 33]), torch.tensor([1.0, -1.0, 1.0, 1.0]),
                  torch.tensor([True, True, False, True]))
    want["update"] = (st.mu.clone(), st.sig2.clone())
    st.hyper.length_scale = torch.tensor(2.0)
    st = tgp.gp_fit(st)
    want["fit"] = (st.mu, st.sig2)
    for step, (mu, sig2) in want.items():
        np.testing.assert_allclose(parts[step]["mu"], mu.numpy(), atol=F32_ATOL, err_msg=step)
        np.testing.assert_allclose(parts[step]["sig2"], sig2.numpy(), atol=F32_ATOL, err_msg=step)


def test_shard_state_lays_out_rows_and_columns_and_needs_padding():
    ds = _dataset()
    x, _ = sh.pad_to_devices(ds.x, 4)
    st = tgp.gp_set_query(tgp.gp_init(torch.from_numpy(x), LS, VAR, NOISE, CAP), 3)
    with make_mesh(1, device="cpu") as mesh:
        one = sh.shard_state(st, mesh)
        assert torch.equal(one.v, st.v) and torch.equal(one.x2, st.x2) and one.count == 1
        assert one.v.data_ptr() != st.v.data_ptr()  # its own buffers
        mesh.rank, mesh.size = 1, 4  # the layout of rank 1 of 4, read only
        part = sh.shard_state(st, mesh)
        assert torch.equal(part.x, st.x[57:114]) and torch.equal(part.v, st.v[:, 57:114])
        assert torch.equal(part.l, st.l) and torch.equal(part.idx, st.idx)
        with pytest.raises(ValueError, match="pad first"):
            sh.shard_state(tgp.gp_init(torch.from_numpy(ds.x), LS, VAR, NOISE, CAP), mesh)
        mesh.rank, mesh.size = 0, 1


def test_make_mesh_refuses_missing_cards_and_an_open_group(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="requested 2 devices, only 1 available"):
        make_mesh(2, device="cuda", store_path="unused")
    with make_mesh(1, device="cpu") as mesh:
        assert (mesh.size, mesh.rank, mesh.backend, mesh.device.type) == (1, 0, "gloo", "cpu")
        with pytest.raises(RuntimeError, match="already initialised"):
            make_mesh(1, device="cpu")
    with make_mesh(1, device="cpu") as again:  # one after another in one process
        x = torch.ones(3)
        assert torch.equal(sh.psum(again, x), torch.ones(3))


def _failing_rank(mesh):
    if mesh.rank == 1:
        raise RuntimeError("rank 1 failed on purpose")
    sh.psum(mesh, torch.ones(1))  # would wait for rank 1 forever
    return "unreachable"


def test_a_failing_rank_fails_the_launch_with_its_traceback():
    with pytest.raises(RankFailed, match="(?s)rank 1 of 2 failed first.*rank 1 failed on purpose"):
        launch(2, _failing_rank, device="cpu")


def test_unregistered_and_oversized_requests_raise():
    with make_mesh(1, device="cpu") as mesh:
        with pytest.raises(KeyError, match="unknown strategy"):
            sh.make_sharded_select(mesh, strategy="nope")
        with pytest.raises(ValueError, match="exceeds the supported maximum"):
            sh.make_sharded_select(mesh, batch_size=tital.MAX_MI_BATCH + 1)
        with pytest.raises(ValueError, match="mutually exclusive"):
            sh.make_sharded_select(mesh, pool_size=8, subsample_size=8)

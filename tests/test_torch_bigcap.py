"""The port's large-cap path (``ital_tpu_torch.parallel.bigcap``) against
``ital_tpu.parallel.bigcap``, against the port's own single-device fit and
replicated sharded round, and through the runner.

Each mesh is a gloo group of 2 or 4 CPU processes, started once for the
fit and round cases (:func:`worlds`), on the reference's 240-row toy corpus
at cap 64.  The reference runs at the same mesh size on the conftest's
virtual CPU devices, from the same state, and its draws (the user's
uniforms, the QMC shifts) are fed to the port through its seams.  Batches
are equal; ``mu``, ``sig2`` and ``beta`` agree with the reference within
1e-4 (the two packages' distributed refits sum in other orders; the
reference holds itself to its replicated path within 2e-3) and with the
port's own ``gp_fit`` and replicated round within 1e-5.  The runner cases
spawn a world of 2 per run.

The spawned ranks import this module, so it imports neither ``jax`` nor
``ital_tpu`` at its top: the reference runs in the test bodies.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ital_tpu_torch import runner as trunner
from ital_tpu_torch.data.datasets import toy_gaussians
from ital_tpu_torch.models import gp as tgp
from ital_tpu_torch.parallel import bigcap, launch, make_mesh, sharded as sh
from ital_tpu_torch.select.base import StrategyParams
from ital_tpu_torch.utils import checkpoint as tckpt
from ital_tpu_torch.utils import config as tconfig

LS, VAR, NOISE = 1.5, 1.0, 0.1
CAP, B, ROUNDS, QUERY = 64, 2, 3, 4
USER = dict(label_prob=0.9, mistake_prob=0.05)
MESHES = (2, 4)
JAX_ATOL, PORT_ATOL, AP_ATOL = 1e-4, 1e-5, 1e-6
ROUND_CASES = {
    "ital": ("ital", {"n_qmc": 32}),
    "ital:production": ("ital", {"n_qmc": 16, "pool_size": 24, "refine_top": 8,
                                 "refine_n_qmc": 64, "randomize_qmc": True}),
    "uncertainty_sampling": ("uncertainty_sampling", {}),
}
# Enough labels to cross three block-row panels of 32 on 4 ranks: 11 + 5 x 16
# = 91 slots of cap 128.
PANEL_CAP, PANEL_B, PANEL_ROUNDS, PANEL_MESH = 128, 16, 5, 4
FIT_IDX, FIT_Y, FIT_VALID = [10, 50, 90, 130], [1.0, -1.0, 1.0, -1.0], [True, False, True, True]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _round_cases(p):
    """The round cases at mesh size ``p``: the multi-panel one on 4 ranks."""
    if p != PANEL_MESH:
        return ROUND_CASES
    return {**ROUND_CASES, "panels": ("uncertainty_sampling", {})}


def _dataset():
    return toy_gaussians(n_per_class=80, n_classes=3, dim=2, seed=5)  # 240 rows


# -- the reference's side, in the parent ----------------------------------------


def _jax_side(p, cases=None):
    """The reference's fit and rounds at mesh size ``p`` (the round cases
    ``cases``, default :func:`_round_cases`), their draws and the states
    they start from, as NumPy arrays."""
    import jax
    import jax.numpy as jnp

    from ital_tpu.models import gp as jgp
    from ital_tpu.parallel import make_mesh as jmesh
    from ital_tpu.parallel.bigcap import make_bigcap_fit, make_bigcap_round, shard_state_bigcap
    from ital_tpu.parallel.sharded import make_masks
    from ital_tpu.select import ital as jital
    from ital_tpu.select.base import StrategyParams as JaxParams
    from tests.test_torch_gp import jax_state_arrays

    ds = _dataset()
    mesh = jmesh(p)
    cls = int(ds.labels[QUERY])
    relevant = jnp.asarray(ds.relevance[:, cls])
    sel_forbid, ap_exclude = make_masks(ds.n, ds.n, QUERY)
    params = JaxParams(label_prob=jnp.asarray(USER["label_prob"]),
                       mistake_prob=jnp.asarray(USER["mistake_prob"]))
    out = {"relevant": np.asarray(relevant), "sel_forbid": np.asarray(sel_forbid),
           "ap_exclude": np.asarray(ap_exclude), "rounds": {}}

    start = {}
    # A query and ten spread labels: distinct MI scores, no saturated-MI ties.
    picks = list(range(5, ds.n, 24))
    ys = [1.0 if ds.relevance[i, cls] else -1.0 for i in picks]
    for cap in (CAP, PANEL_CAP):
        st = jgp.gp_set_query(jgp.gp_init(jnp.asarray(ds.x), LS, VAR, NOISE, cap=cap),
                              jnp.asarray(QUERY))
        start[cap] = jgp.gp_update(st, jnp.asarray(picks, jnp.int32),
                                   jnp.asarray(ys, jnp.float32), jnp.ones(len(picks), bool))
        out[f"start{cap}"] = jax_state_arrays(start[cap])

    warm = jgp.gp_update(
        jgp.gp_set_query(jgp.gp_init(jnp.asarray(ds.x), LS, VAR, NOISE, cap=CAP),
                         jnp.asarray(QUERY)),
        jnp.asarray(FIT_IDX, jnp.int32), jnp.asarray(FIT_Y, jnp.float32),
        jnp.asarray(FIT_VALID))
    out["warm"] = jax_state_arrays(warm)
    fitted = make_bigcap_fit(mesh)(shard_state_bigcap(warm, mesh))
    out["fit"] = {f: np.asarray(getattr(fitted, f)) for f in ("mu", "sig2", "beta", "l")}

    key = jax.random.PRNGKey(11)
    for name, (strategy, opts) in (_round_cases(p) if cases is None else cases).items():
        cap, b, n_rounds = ((PANEL_CAP, PANEL_B, PANEL_ROUNDS) if name == "panels"
                            else (CAP, B, ROUNDS))
        fn = make_bigcap_round(mesh, strategy=strategy, batch_size=b, recall_ks=(10,), **opts)
        st = shard_state_bigcap(start[cap], mesh)
        rounds = []
        for rnd in range(n_rounds):
            rkey = jax.random.fold_in(key, rnd)
            k_sel, k_user = jax.random.split(rkey)
            k_label, k_flip = jax.random.split(k_user)
            st, batch, ap, _ = fn(st, rkey, relevant, sel_forbid, ap_exclude, params)
            rounds.append({
                "u_label": np.asarray(jax.random.uniform(k_label, (b,))),
                "u_flip": np.asarray(jax.random.uniform(k_flip, (b,))),
                "shifts": [np.asarray(jital._step_shift(k_sel, t, jnp.float32)) for t in range(b)],
                "batch": np.asarray(batch), "ap": float(ap), "mu": np.asarray(st.mu),
                "sig2": np.asarray(st.sig2)})
        out["rounds"][name] = rounds
    return out


@pytest.fixture(scope="module")
def jax_side():
    return {p: _jax_side(p) for p in MESHES}


# -- the port's side, on every rank of a gloo mesh --------------------------------


def _gathered(mesh, state):
    return {f: sh.all_gather_cat(mesh, getattr(state, f)).numpy() for f in ("mu", "sig2")}


def _run_rounds(mesh, payload, name, strategy, opts, make_round, layout):
    cap, b = (PANEL_CAP, PANEL_B) if name == "panels" else (CAP, B)
    masks = [torch.from_numpy(payload[k]) for k in ("relevant", "sel_forbid", "ap_exclude")]
    state = layout(tgp.state_from_arrays(payload[f"start{cap}"], "cpu"), mesh)
    fn = make_round(mesh, strategy=strategy, batch_size=b, recall_ks=(10,), **opts)
    params = StrategyParams.create("cpu", **USER)
    rounds = []
    for draws in payload["rounds"][name]:
        fed = ({"qmc_shifts": [torch.from_numpy(s) for s in draws["shifts"]]}
               if opts.get("randomize_qmc") else {})
        state, batch, ap, recalls = fn(state, None, torch.from_numpy(draws["u_label"]),
                                       torch.from_numpy(draws["u_flip"]), *masks, params, **fed)
        rounds.append({"batch": batch.numpy(), "ap": float(ap), "recall": float(recalls[0]),
                       "l_shape": tuple(state.l.shape), **_gathered(mesh, state)})
    return rounds


def _rank_main(mesh, payload):
    out = {}
    warm = tgp.state_from_arrays(payload["warm"], "cpu")
    fitted = bigcap.make_bigcap_fit(mesh)(bigcap.shard_state_bigcap(warm, mesh))
    out["fit"] = {**_gathered(mesh, fitted), "beta": fitted.beta.numpy(),
                  "l": sh.all_gather_cat(mesh, fitted.l).numpy(),
                  "l_shape": tuple(fitted.l.shape)}
    # The layout from an already-sharded state whose l is replicated, and
    # the snapshot layout of a block-row l.
    again = bigcap.shard_state_bigcap(sh.shard_state(warm, mesh), mesh, corpus_sharded=True)
    out["layout_equal"] = all(torch.equal(getattr(again, f), getattr(
        bigcap.shard_state_bigcap(warm, mesh), f)) for f in ("l", "x", "v", "mu"))
    out["gathered_l"] = sh.gather_session(mesh, fitted).l.numpy()

    for name, (strategy, opts) in _round_cases(mesh.size).items():
        out[name] = _run_rounds(mesh, payload, name, strategy, opts, bigcap.make_bigcap_round,
                                bigcap.shard_state_bigcap)
        out[f"replicated:{name}"] = _run_rounds(mesh, payload, name, strategy, opts,
                                                sh.make_sharded_round, sh.shard_state)
    try:
        bad = dataclasses.replace(warm, idx=warm.idx[:-1], y=warm.y[:-1], valid=warm.valid[:-1])
        bigcap.make_bigcap_fit(mesh)(bad)
        out["indivisible"] = None
    except ValueError as exc:
        out["indivisible"] = str(exc)
    return out


def _payload(js):
    keep = ("relevant", "sel_forbid", "ap_exclude", "warm", f"start{CAP}", f"start{PANEL_CAP}")
    return {**{k: js[k] for k in keep},
            "rounds": {name: [{k: r[k] for k in ("u_label", "u_flip", "shifts")} for r in rs]
                       for name, rs in js["rounds"].items()}}


@pytest.fixture(scope="module")
def worlds(jax_side):
    """Each mesh size's results, from one spawned gloo world each."""
    return {p: launch(p, _rank_main, _payload(jax_side[p]), device="cpu") for p in MESHES}


# -- the fit and the round ---------------------------------------------------------


@pytest.mark.parametrize("p", MESHES)
def test_bigcap_fit_equals_jax_and_gp_fit(worlds, jax_side, p):
    """The distributed refit of a state with a skipped slot: the reference's
    and the port's single-device ``gp_fit``."""
    got, want = worlds[p]["fit"], jax_side[p]["fit"]
    single = tgp.gp_fit(tgp.state_from_arrays(jax_side[p]["warm"], "cpu"))
    for f in ("mu", "sig2", "beta"):
        np.testing.assert_allclose(got[f], want[f], rtol=0, atol=JAX_ATOL, err_msg=f)
        np.testing.assert_allclose(got[f], getattr(single, f).numpy(), rtol=0, atol=PORT_ATOL,
                                   err_msg=f)
    np.testing.assert_allclose(got["l"], want["l"], rtol=0, atol=3e-5)
    np.testing.assert_allclose(got["l"], single.l.numpy(), rtol=0, atol=PORT_ATOL)
    assert got["l_shape"] == (CAP // p, CAP)


@pytest.mark.parametrize("p", MESHES)
def test_layouts_and_the_gathered_factor(worlds, p):
    parts = worlds[p]
    assert parts["layout_equal"]
    np.testing.assert_array_equal(parts["gathered_l"], parts["fit"]["l"])
    msg = parts["indivisible"]
    assert msg is not None and "divide evenly" in msg and f"{p}-device mesh" in msg


def _assert_rounds(got, want, atol, what):
    for rnd, (g, w) in enumerate(zip(got, want, strict=True)):
        err = f"{what} round {rnd}"
        np.testing.assert_array_equal(g["batch"], w["batch"], err_msg=err)
        for f in ("mu", "sig2"):
            np.testing.assert_allclose(g[f], w[f], rtol=0, atol=atol, err_msg=f"{err} {f}")
        assert abs(g["ap"] - w["ap"]) <= max(atol, AP_ATOL), err


@pytest.mark.parametrize("p,name", [(p, name) for p in MESHES for name in _round_cases(p)])
def test_bigcap_round_equals_jax_and_the_replicated_round(worlds, jax_side, p, name):
    """Batches equal, ``mu``/``sig2`` close, round by round, against the
    reference's bigcap round on its draws and the port's replicated sharded
    round on the same draws; ``l`` stays in block-rows.  "panels" labels 91
    slots of cap 128, across three of the factor's four block-row panels."""
    got = worlds[p][name]
    _assert_rounds(got, jax_side[p]["rounds"][name], JAX_ATOL, f"jax {name}")
    _assert_rounds(got, worlds[p][f"replicated:{name}"], PORT_ATOL, f"replicated {name}")
    cap = PANEL_CAP if name == "panels" else CAP
    assert all(r["l_shape"] == (cap // p, cap) for r in got)
    assert all(0.0 <= r["recall"] <= 1.0 for r in got)


# -- the runner ---------------------------------------------------------------------


def _cfg(mesh=2, gp=None, **kw):
    base = dict(
        dataset="toy", dataset_kwargs=dict(n_per_class=45, n_classes=3, dim=2, seed=0),
        method="ital", batch_size=2, n_rounds=3, repetitions=1, queries_per_class=1,
        max_classes=2, seed=0, mesh_devices=mesh,
        gp=tconfig.GPConfig(**{"length_scale": 1.5, "var": 1.0, "noise": 0.1, "cap": 16,
                               "chol2d_threshold": 16, **(gp or {})}),
        user=tconfig.UserConfig(label_prob=0.8, mistake_prob=0.1),
        method_kwargs={"n_qmc": 16, "pool_size": 30, "refine_top": 8, "refine_n_qmc": 64,
                       "randomize_qmc": True},
    )
    base.update(kw)
    return tconfig.ExperimentConfig(**base)


def _run(**kw):
    return trunner.run_experiment(_cfg(**kw), device="cpu")


@pytest.mark.parametrize("gp", [{}, {"learn_every": 2, "learn_steps": 20}],
                         ids=["plain", "learn_every"])
def test_runner_past_the_threshold_takes_the_bigcap_path(gp, capsys):
    """cap 16 >= GP.chol2d_threshold 16 on a mesh of 2: the distributed
    refit (re-learning refits with it too), with the curves of
    ``GP.chol2d_threshold = 0`` on the same mesh."""
    got = _run(gp=gp)
    out = capsys.readouterr().out
    assert got.get("chol2d") is True and got["mesh_devices"] == 2
    assert "# cap=16 >= chol2d_threshold=16: distributed chol2d refit path (l row-sharded " \
           "over 2 devices)" in out
    want = _run(gp={**gp, "chol2d_threshold": 0})
    assert "chol2d" not in want
    np.testing.assert_allclose(got["ap"], want["ap"], rtol=0, atol=AP_ATOL)


def test_runner_indivisible_cap_warns_and_keeps_the_replicated_factor(capsys):
    got = _run(gp={"cap": 15, "chol2d_threshold": 8})
    out = capsys.readouterr().out
    assert "# WARNING: cap=15 crossed chol2d_threshold=8 but does not divide the 2-device " \
           "mesh; using the REPLICATED factor path" in out
    assert "chol2d" not in got
    want = _run(gp={"cap": 15, "chol2d_threshold": 0})
    np.testing.assert_array_equal(got["ap"], want["ap"])


def test_runner_bigcap_checkpoint_resumes_and_loads_on_one_device(tmp_path):
    """A bigcap snapshot holds the whole (cap, cap) factor in the
    single-device layout: it loads into ``load_session`` on one device, its
    factor is the refit's, and a run resumed from it gives the uninterrupted
    curve."""
    full_dir, part_dir = tmp_path / "full", tmp_path / "part"
    full = _run(checkpoint_dir=str(full_dir))
    part = _run(n_rounds=1, checkpoint_dir=str(part_dir))
    np.testing.assert_array_equal(part["ap"], full["ap"][:, :1])
    resumed = _run(checkpoint_dir=str(part_dir), resume=True)
    assert resumed.get("chol2d") is True
    np.testing.assert_array_equal(resumed["ap"], full["ap"])

    cfg = _cfg()
    ds = toy_gaussians(**cfg.dataset_kwargs)
    x, _ = sh.pad_to_devices(ds.x, 2)
    template = tgp.gp_init(torch.from_numpy(x), 1.5, 1.0, 0.1, 16)
    name = sorted(p.name for p in full_dir.glob("*.npz"))[0]
    state, extras = tckpt.load_session(str(full_dir / name), template)
    assert state.l.shape == (16, 16) and state.count == 1 + 2 * 3
    assert int(extras["next_round"]) == 3
    refit = tgp.gp_fit(dataclasses.replace(state, **{f: getattr(state, f).clone()
                                                     for f in ("l", "v", "mu", "sig2")}))
    np.testing.assert_allclose(state.l.numpy(), refit.l.numpy(), rtol=0, atol=PORT_ATOL)
    np.testing.assert_allclose(state.mu.numpy(), refit.mu.numpy(), rtol=0, atol=PORT_ATOL)
    with make_mesh(1, device="cpu") as mesh:
        again, _ = sh.load_sharded_session(mesh, str(full_dir / name), template)
        assert again.l.shape == (16, 16)

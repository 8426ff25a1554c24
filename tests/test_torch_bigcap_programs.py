"""The large-cap path's programs (``ital_tpu_torch.parallel.bigcap``'s
``bigcap_fit`` and ``bigcap_absorb``, ``parallel.chol2d``'s factories) on the
graph path, against their eager calls and against the reference's
``ital_tpu.parallel.bigcap`` / ``ital_tpu.parallel.chol2d``.

The CPU has no graph, so the stand-in of ``tests/test_torch_mesh_programs.py``
recomputes a program's body, collectives included, at each replay; each
spawned rank turns it on itself, the world of one (in-process) through a
patch that ends with the fixture.  The worlds are gloo groups of 1, 2 and 4
ranks on the reference's 240-row toy corpus, each started once.  Graphed
calls equal eager ones bit for bit and replay without a capture, counting
the RBF launches their capture recorded; they equal the reference run at
the same mesh size on the conftest's virtual CPU devices, on its draws,
within ``tests/test_torch_bigcap.py``'s tolerances (``mu``, ``sig2``,
``beta`` 1e-4, ``l`` 3e-5, batches equal; the chol2d factories within
``tests/test_torch_chol2d.py``'s).  The three-panel round labels 91 slots of
cap 128 on 4 ranks.  A block that is not positive definite (a negative
noise) raises on every rank, graphed or eager, and leaves the session as it
was.  The runner's large-cap run with ``GP.learn_every`` (its re-learn's
labeled rows and refit are programs of the mesh) gives its eager curve.

The spawned ranks import this module, so it imports neither ``jax`` nor
``ital_tpu`` at its top: the reference runs in the test bodies.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from ital_tpu_torch import graphs
from ital_tpu_torch import runner as trunner
from ital_tpu_torch.data.datasets import toy_gaussians
from ital_tpu_torch.models import gp as tgp
from ital_tpu_torch.ops import kernels, rbf_hopper
from ital_tpu_torch.parallel import bigcap, chol2d, launch, sharded as sh
from ital_tpu_torch.select.base import StrategyParams
from tests import test_torch_bigcap as tb
from tests import test_torch_chol2d as tc
from tests.test_torch_mesh_programs import _capture_graph, _counted_rbf, _stand_in

MESHES = (1, 2, 4)
ROUND_CASES = {"ital:production": tb.ROUND_CASES["ital:production"]}
PANELS = ("uncertainty_sampling", {})
CHOL_CASES = ("cholesky", "cho_solve", "whiten")
FIT_LAUNCHES = 2  # the K_ll block-row and the cross block
LEARN_GP = {"learn_every": 2, "learn_steps": 20}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _round_cases(p):
    return {**ROUND_CASES, **({"panels": PANELS} if p == tb.PANEL_MESH else {})}


def _cases(p):
    return (*CHOL_CASES, "fit", *_round_cases(p))


# -- the reference's side, in the parent ----------------------------------------


def _jax_chol2d(p):
    """The reference's chol2d factories at mesh size ``p`` on
    ``tests/test_torch_chol2d.py``'s inputs."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ital_tpu.parallel.chol2d import make_sharded_cho_solve, make_sharded_whiten
    from ital_tpu.parallel.mesh import CORPUS_AXIS

    _, l64 = tc._jax_factor(p, tc.INPUTS["factor64"])
    mesh, l = tc._jax_factor(p, tc.INPUTS["solve"])
    solved = make_sharded_cho_solve(mesh)(l, jnp.asarray(tc.INPUTS["solve"]["b"]))
    mesh, l = tc._jax_factor(p, tc.INPUTS["whiten"])
    kx = jax.device_put(jnp.asarray(tc.INPUTS["whiten"]["kx"]),
                        NamedSharding(mesh, P(None, CORPUS_AXIS)))
    return {"cholesky": {"l": np.asarray(l64)}, "cho_solve": {"x": np.asarray(solved)},
            "whiten": {"v": np.asarray(make_sharded_whiten(mesh)(l, kx))}}


@pytest.fixture(scope="module")
def jax_side():
    out = {}
    for p in MESHES:
        out[p] = tb._jax_side(p, _round_cases(p))
        out[p]["chol2d"] = _jax_chol2d(p)
    return out


# -- the port's side, on every rank ----------------------------------------------


def _gathered(mesh, state):
    return {"mu": sh.all_gather_cat(mesh, state.mu).numpy(),
            "sig2": sh.all_gather_cat(mesh, state.sig2).numpy(),
            "beta": state.beta.numpy(), "l": sh.all_gather_cat(mesh, state.l).numpy(),
            "v": sh.all_gather_cat(mesh, state.v.T.contiguous()).T.numpy(),
            "count": np.asarray(state.count)}


def _chol_cases(mesh):
    """The chol2d factories' calls on ``tests/test_torch_chol2d.py``'s
    inputs, each from inputs of its own (the factors the solves take are
    made once, eagerly)."""
    t = {name: {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
                for k, v in case.items()} for name, case in tc.INPUTS.items()}
    with graphs.eager():
        l_solve, l_whiten = (tc._factor(mesh, tc.INPUTS[n]) for n in ("solve", "whiten"))
    n_loc = t["whiten"]["kx"].shape[1] // mesh.size
    cols = t["whiten"]["kx"][:, mesh.rank * n_loc:(mesh.rank + 1) * n_loc].contiguous()

    def cholesky():
        c = t["factor64"]
        l = chol2d.make_sharded_cholesky(mesh)(chol2d.shard_rows(c["k"], mesh), c["active"],
                                               c["noise"])
        return {"l": sh.all_gather_cat(mesh, l).numpy()}

    def cho_solve():
        return {"x": chol2d.make_sharded_cho_solve(mesh)(l_solve, t["solve"]["b"]).numpy()}

    def whiten():
        before = cols.clone()
        v = chol2d.make_sharded_whiten(mesh)(l_whiten, cols)
        assert torch.equal(cols, before)  # the program leaves K as it was
        return {"v": sh.all_gather_cat(mesh, v.T.contiguous()).T.numpy()}

    return {"cholesky": cholesky, "cho_solve": cho_solve, "whiten": whiten}


def _layout(corpus: dict):
    """``shard_state_bigcap`` over one corpus shard ``corpus`` (``x``,
    ``x2``), which every call shares, as a run's sessions do."""
    return lambda state, mesh: dataclasses.replace(bigcap.shard_state_bigcap(state, mesh),
                                                   **corpus)


def _fit(mesh, payload, layout):
    def fit():
        state = layout(tgp.state_from_arrays(payload["warm"], "cpu"), mesh)
        out = bigcap.make_bigcap_fit(mesh)(state)
        assert out is state
        return _gathered(mesh, state)

    return fit


def _round(mesh, payload, name, strategy, opts, layout):
    def rounds():
        got = tb._run_rounds(mesh, payload, name, strategy, opts, bigcap.make_bigcap_round,
                             layout)
        return {k: np.stack([np.asarray(r[k]) for r in got])
                for k in ("batch", "ap", "recall", "mu", "sig2", "l_shape")}

    return rounds


def _replay_launches(mesh, fn) -> tuple:
    """``fn()``'s kernel launches as counted, and the launches its programs'
    captures recorded times their replays in the call."""
    progs = [p for p in graphs.programs() if p.mesh == mesh.uid]
    replays = {id(p): p.replays for p in progs}
    l0 = rbf_hopper.LAUNCHES
    fn()
    recorded = sum(sum(p.launches.values()) * (p.replays - replays[id(p)]) for p in progs)
    return rbf_hopper.LAUNCHES - l0, recorded


def _state_flags(before, after) -> bool:
    return (all(torch.equal(getattr(before, f), getattr(after, f)) for f in tgp.SESSION_FIELDS)
            and before.count == after.count)


def _not_positive_definite(mesh, payload, layout):
    """A negative noise makes the labeled block indefinite: do the fit, the
    round and the factorization raise a check's failure on every rank,
    graphed and eager, and leave the session as it was?"""
    # The selection (uncertainty sampling) reads no hyperparameter: the
    # absorption's refit is what fails.
    draws = payload["rounds"][next(iter(ROUND_CASES))][0]
    masks = [torch.from_numpy(payload[k]) for k in ("relevant", "sel_forbid", "ap_exclude")]
    params = StrategyParams.create("cpu", **tb.USER)
    c = tc.INPUTS["factor64"]
    out = {}
    for mode in ("graphed", "eager"):
        flags = []
        for call in ("fit", "round", "cholesky"):
            state = layout(tgp.state_from_arrays(payload["warm"], "cpu"), mesh)
            state.hyper = dataclasses.replace(state.hyper, noise=torch.tensor(-2.0))
            before = tgp.gp_session_copy(state)
            try:
                with graphs.eager() if mode == "eager" else contextlib.nullcontext():
                    if call == "fit":
                        bigcap.make_bigcap_fit(mesh)(state)
                    elif call == "round":
                        bigcap.make_bigcap_round(mesh, strategy=PANELS[0], batch_size=tb.B,
                                                 recall_ks=(10,))(
                            state, None, torch.from_numpy(draws["u_label"]),
                            torch.from_numpy(draws["u_flip"]), *masks, params)
                    else:
                        chol2d.make_sharded_cholesky(mesh)(
                            chol2d.shard_rows(torch.from_numpy(c["k"]), mesh),
                            torch.from_numpy(c["active"]), -2.0)
                raised = False
            except torch.linalg.LinAlgError as exc:
                raised = graphs.uniform_failure(exc)
            flags += [raised, _state_flags(before, state)]
        t = torch.tensor(flags, dtype=torch.float32)[None]
        out[mode] = sh.all_gather_cat(mesh, t).numpy()  # (ranks, 6)
    return out


def _runner(mesh):
    """The runner's large-cap run with ``GP.learn_every`` on this mesh,
    eager then graphed: the AP curves, the captures of the graphed run and
    the mesh's programs."""
    cfg = tb._cfg(mesh=mesh.size, gp=LEARN_GP)
    ds = toy_gaussians(**cfg.dataset_kwargs)
    with graphs.eager():
        eager = trunner._sharded_run(mesh, cfg, ds)
    c0 = graphs.captures()
    graphed = trunner._sharded_run(mesh, cfg, ds)
    return {"eager": eager["ap"], "graphed": graphed["ap"], "chol2d": graphed.get("chol2d"),
            "captures": graphs.captures() - c0,
            "programs": sorted({p.name for p in graphs.programs() if p.mesh == mesh.uid})}


def _rank_main(mesh, payload):
    """Every case on this mesh, eager, graphed and graphed again; rank 0
    keeps the results.  A spawned rank turns the stand-in graph on itself."""
    if mesh.size > 1:
        _stand_in()
    shard = sh.shard_state(tgp.state_from_arrays(payload["warm"], "cpu"), mesh)
    layout = _layout({"x": shard.x, "x2": shard.x2})
    cases = {**_chol_cases(mesh), "fit": _fit(mesh, payload, layout),
             **{name: _round(mesh, payload, name, strategy, opts, layout)
                for name, (strategy, opts) in _round_cases(mesh.size).items()}}
    out = {"eager": {}, "graphed": {}, "again": {}, "captures": {}, "launches": {}}
    for name, fn in cases.items():
        l0 = rbf_hopper.LAUNCHES
        with graphs.eager():
            out["eager"][name] = fn()
        eager_launches = rbf_hopper.LAUNCHES - l0
        c0 = graphs.captures()
        out["graphed"][name] = fn()
        c1 = graphs.captures()
        holder = {}
        counted, recorded = _replay_launches(mesh, lambda: holder.setdefault("again", fn()))
        out["again"][name] = holder["again"]
        out["captures"][name] = (c1 - c0, graphs.captures() - c1)
        out["launches"][name] = (eager_launches, counted, recorded)
    out["recorded"] = {p.name: sum(p.launches.values()) for p in graphs.programs()
                       if p.mesh == mesh.uid}
    out["indefinite"] = _not_positive_definite(mesh, payload, layout)
    out["runner"] = _runner(mesh)
    return out


@pytest.fixture(scope="module")
def worlds(jax_side):
    """Each mesh size's results: a world of one in-process on the stand-in
    (patched for this fixture only), larger ones spawned."""
    out = {}
    for p in MESHES:
        payload = tb._payload(jax_side[p])
        if p == 1:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(graphs, "_PROGRAMS", {})
                mp.setattr(graphs, "_STAGES", {})
                mp.setattr(graphs, "_GRAPH_DEVICES", ("cuda", "cpu"))
                mp.setattr(graphs, "_capture_graph", _capture_graph)
                mp.setattr(kernels, "_rbf_forward", _counted_rbf)
                out[p] = launch(1, _rank_main, payload, device="cpu")
        else:
            out[p] = launch(p, _rank_main, payload, device="cpu")
    return out


def _cases_at():
    return [(p, name) for p in MESHES for name in _cases(p)]


def _assert_equal(got, want, what):
    assert got.keys() == want.keys(), what
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what}.{k}")


# -- against eager ---------------------------------------------------------------


@pytest.mark.parametrize("p,case", _cases_at())
def test_a_graphed_large_cap_program_equals_its_eager_call_bit_for_bit(worlds, p, case):
    got = worlds[p]
    _assert_equal(got["graphed"][case], got["eager"][case], case)
    _assert_equal(got["again"][case], got["graphed"][case], f"{case} replayed")


@pytest.mark.parametrize("p,case", _cases_at())
def test_a_second_call_captures_nothing_and_counts_the_recorded_launches(worlds, p, case):
    first, second = worlds[p]["captures"][case]
    assert first >= 1 and second == 0, (first, second)
    eager, counted, recorded = worlds[p]["launches"][case]
    assert counted == recorded == eager, (eager, counted, recorded)


@pytest.mark.parametrize("p", MESHES)
def test_the_refit_and_the_absorption_launch_the_kernel_twice_a_replay(worlds, p):
    """The K_ll block-row and the cross block, inside each program; the
    chol2d programs launch none, the fit case one refit."""
    rec = worlds[p]["recorded"]
    assert rec["bigcap_fit"] == rec["bigcap_absorb"] == FIT_LAUNCHES, rec
    assert rec["chol2d_cholesky"] == rec["chol2d_cho_solve"] == rec["chol2d_whiten"] == 0
    assert worlds[p]["launches"]["fit"][0] == FIT_LAUNCHES


# -- against the reference -------------------------------------------------------


@pytest.mark.parametrize("p", MESHES)
def test_the_refit_program_equals_the_reference(worlds, jax_side, p):
    got, want = worlds[p]["graphed"]["fit"], jax_side[p]["fit"]
    for f in ("mu", "sig2", "beta"):
        np.testing.assert_allclose(got[f], want[f], rtol=0, atol=tb.JAX_ATOL, err_msg=f)
    np.testing.assert_allclose(got["l"], want["l"], rtol=0, atol=3e-5)
    assert got["l"].shape == (tb.CAP, tb.CAP)


@pytest.mark.parametrize("p,name", [(p, n) for p in MESHES for n in _round_cases(p)])
def test_the_round_programs_equal_the_reference(worlds, jax_side, p, name):
    """Batches equal, ``mu``/``sig2`` close round by round, ``l`` in
    block-rows; "panels" crosses three of the factor's four panels."""
    got, want = worlds[p]["graphed"][name], jax_side[p]["rounds"][name]
    np.testing.assert_array_equal(got["batch"], np.stack([w["batch"] for w in want]))
    for f in ("mu", "sig2"):
        np.testing.assert_allclose(got[f], np.stack([w[f] for w in want]), rtol=0,
                                   atol=tb.JAX_ATOL, err_msg=f)
    np.testing.assert_allclose(got["ap"], [w["ap"] for w in want], rtol=0, atol=tb.JAX_ATOL)
    cap = tb.PANEL_CAP if name == "panels" else tb.CAP
    assert (got["l_shape"] == (cap // p, cap)).all()


@pytest.mark.parametrize("p,case", [(p, c) for p in MESHES for c in CHOL_CASES])
def test_the_chol2d_programs_equal_the_reference(worlds, jax_side, p, case):
    got, want = worlds[p]["graphed"][case], jax_side[p]["chol2d"][case]
    atol = tc.FACTOR_ATOL if case == "cholesky" else tc.SOLVE_ATOL
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol, err_msg=k)


# -- failures and the runner -----------------------------------------------------


@pytest.mark.parametrize("mode", ["graphed", "eager"])
@pytest.mark.parametrize("p", MESHES)
def test_an_indefinite_block_raises_on_every_rank_and_leaves_the_session(worlds, p, mode):
    flags = worlds[p]["indefinite"][mode]
    assert flags.shape == (p, 6)
    assert (flags == 1.0).all(), flags


@pytest.mark.parametrize("p", MESHES)
def test_the_runner_large_cap_run_with_learning_gives_its_eager_curve(worlds, p):
    got = worlds[p]["runner"]
    assert got["chol2d"] is True and got["captures"] >= 1
    np.testing.assert_array_equal(got["graphed"], got["eager"])
    assert {"bigcap_absorb", "bigcap_fit", "sharded_labeled_rows",
            "sharded_select", "sharded_set_query"} <= set(got["programs"])

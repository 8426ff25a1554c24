"""The port's cap-sharded Cholesky and solves (``ital_tpu_torch.parallel.chol2d``)
against ``ital_tpu.parallel.chol2d`` and against the port's single-device
padded path.

Each mesh is a gloo group of 2 or 4 CPU processes, started once for all the
cases of this file (:func:`worlds`); the reference runs at the same mesh
size on the conftest's virtual CPU devices, on the same NumPy inputs.  The
sums of the transpose solve and the panel products round otherwise than
JAX's ``psum`` and dots: factors agree within 3e-5, solves and the whitening
within 5e-5, as the reference's own tests hold its path to the
single-device one.

The spawned ranks import this module, so it imports neither ``jax`` nor
``ital_tpu`` at its top: the reference runs in the test bodies.
"""

import numpy as np
import pytest
import torch

from ital_tpu_torch.models import gp as tgp
from ital_tpu_torch.ops import chol as tchol
from ital_tpu_torch.ops.kernels import rbf_kernel
from ital_tpu_torch.parallel import launch, make_mesh, sharded as sh
from ital_tpu_torch.parallel import chol2d

MESHES = (2, 4)
FACTOR_ATOL, SOLVE_ATOL, MU_ATOL = 3e-5, 5e-5, 1e-4
FACTOR_CAPS = (16, 64)
BIG_CAP, BIG_MESH = 512, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _spd(rng, cap):
    a = rng.normal(size=(cap, cap)).astype(np.float32)
    return (a @ a.T / cap + np.eye(cap, dtype=np.float32)).astype(np.float32)


def _inputs():
    """Every case's NumPy inputs, made once from a seed."""
    rng = np.random.default_rng(0)
    out = {}
    for cap in FACTOR_CAPS:
        # A padded tail and an inert hole in the middle.
        active = np.ones(cap, bool)
        active[cap // 2] = False
        active[cap - 3:] = False
        out[f"factor{cap}"] = dict(k=_spd(rng, cap), active=active, noise=0.1)
    active = np.ones(32, bool)
    active[-4:] = False
    b = rng.normal(size=(32, 5)).astype(np.float32)
    b[~active] = 0.0  # padded slots' right-hand sides are zero upstream
    out["solve"] = dict(k=_spd(rng, 32), active=active, noise=0.05, b=b)
    active = np.ones(24, bool)
    active[-2:] = False
    kx = rng.normal(size=(24, 40)).astype(np.float32)
    kx[~active] = 0.0
    out["whiten"] = dict(k=_spd(rng, 24), active=active, noise=0.0, kx=kx)
    # The GP fit pipeline: a state with a query and eight labels.
    x = rng.normal(size=(64, 6)).astype(np.float32)
    st = tgp.gp_init(torch.from_numpy(x), 2.0, 1.0, 0.1, 16)
    idx = rng.choice(64, size=9, replace=False)
    y = rng.choice([-1.0, 1.0], size=9).astype(np.float32)
    st = tgp.gp_update(st, torch.from_numpy(idx), torch.from_numpy(y), torch.ones(9, dtype=bool))
    out["fit"] = dict(x=x, idx=st.idx.numpy(), y=st.y.numpy(), active=st.active.numpy(),
                      mu=st.mu.numpy().copy())
    active = np.ones(BIG_CAP, bool)
    active[500:] = False
    out["big"] = dict(k=_spd(rng, BIG_CAP), active=active, noise=0.1)
    return out


INPUTS = _inputs()


# -- the port's side, on every rank of a gloo mesh --------------------------------


def _gather_rows(mesh, t):
    return sh.all_gather_cat(mesh, t).numpy()


def _factor(mesh, case):
    c = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v for k, v in case.items()}
    return chol2d.make_sharded_cholesky(mesh)(chol2d.shard_rows(c["k"], mesh), c["active"],
                                              c["noise"])


def _rank_main(mesh, inputs):
    out = {}
    for cap in FACTOR_CAPS:
        out[f"factor{cap}"] = _gather_rows(mesh, _factor(mesh, inputs[f"factor{cap}"]))
    if mesh.size == BIG_MESH:
        out["big"] = _gather_rows(mesh, _factor(mesh, inputs["big"]))
    case = inputs["solve"]
    l = _factor(mesh, case)
    out["solve"] = chol2d.make_sharded_cho_solve(mesh)(l, torch.from_numpy(case["b"])).numpy()
    out["forward"] = chol2d.solve2d_local(mesh, l, torch.from_numpy(case["b"])).numpy()
    out["solve_l"] = _gather_rows(mesh, l)
    case = inputs["whiten"]
    l = _factor(mesh, case)
    n_loc = case["kx"].shape[1] // mesh.size
    cols = torch.from_numpy(case["kx"][:, mesh.rank * n_loc:(mesh.rank + 1) * n_loc].copy())
    v = chol2d.make_sharded_whiten(mesh)(l, cols)
    assert torch.equal(cols, torch.from_numpy(case["kx"][:, mesh.rank * n_loc:
                                                         (mesh.rank + 1) * n_loc]))
    out["whiten"] = sh.all_gather_cat(mesh, v.T.contiguous()).T.numpy()

    # The fit pipeline: the factor of K_ll, then mu = K_lx^T K_ll^-1 y.
    case = inputs["fit"]
    x, idx = torch.from_numpy(case["x"]), torch.from_numpy(case["idx"])
    active = torch.from_numpy(case["active"])
    k_ll = rbf_kernel(x[idx], x[idx], 2.0, 1.0)
    l = chol2d.make_sharded_cholesky(mesh)(chol2d.shard_rows(k_ll, mesh), active, 0.1)
    yv = torch.where(active, torch.from_numpy(case["y"]), 0.0)[:, None]
    alpha = chol2d.make_sharded_cho_solve(mesh)(l, yv)[:, 0]
    k_lx = torch.where(active[:, None], rbf_kernel(x[idx], x, 2.0, 1.0), 0.0)
    out["fit_mu"] = (k_lx.T @ alpha).numpy()

    # A cap that does not divide the mesh: refused before any exchange.
    cap = 4 * mesh.size + 1
    try:
        chol2d.make_sharded_cholesky(mesh)(torch.eye(cap), torch.ones(cap, dtype=bool), 0.1)
        out["indivisible"] = None
    except ValueError as exc:
        out["indivisible"] = str(exc)
    return out


@pytest.fixture(scope="module")
def worlds():
    """Each mesh size's results, from one spawned gloo world each."""
    return {p: launch(p, _rank_main, INPUTS, device="cpu") for p in MESHES}


# -- the reference, in the parent ------------------------------------------------


def _jax_factor(p, case):
    import jax.numpy as jnp

    from ital_tpu.parallel.chol2d import make_sharded_cholesky, shard_rows
    from ital_tpu.parallel.mesh import make_mesh as jmesh

    mesh = jmesh(p)
    return mesh, make_sharded_cholesky(mesh)(
        shard_rows(jnp.asarray(case["k"]), mesh), jnp.asarray(case["active"]),
        jnp.float32(case["noise"]))


def _padded(case):
    return tchol.padded_cholesky(torch.from_numpy(case["k"]), torch.from_numpy(case["active"]),
                                 case["noise"]).numpy()


@pytest.mark.parametrize("cap", FACTOR_CAPS)
@pytest.mark.parametrize("p", MESHES)
def test_sharded_cholesky_matches_jax_and_the_padded_factor(worlds, p, cap):
    case = INPUTS[f"factor{cap}"]
    got = worlds[p][f"factor{cap}"]
    _, want = _jax_factor(p, case)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=FACTOR_ATOL)
    np.testing.assert_allclose(got, _padded(case), rtol=0, atol=FACTOR_ATOL)
    # Identity rows and columns on the inactive slots, zeros above the diagonal.
    off = ~case["active"]
    np.testing.assert_array_equal(got[off][:, off], np.eye(off.sum(), dtype=np.float32))
    assert not np.triu(got, 1).any()


@pytest.mark.parametrize("p", MESHES)
def test_sharded_cho_solve_matches_jax_and_the_single_device_solve(worlds, p):
    import jax.numpy as jnp

    from ital_tpu.parallel.chol2d import make_sharded_cho_solve

    case = INPUTS["solve"]
    got = worlds[p]["solve"]
    mesh, l = _jax_factor(p, case)
    want = np.asarray(make_sharded_cho_solve(mesh)(l, jnp.asarray(case["b"])))
    np.testing.assert_allclose(got, want, rtol=0, atol=SOLVE_ATOL)
    l_one = torch.from_numpy(_padded(case))
    b = torch.from_numpy(case["b"])
    single = torch.linalg.solve_triangular(l_one.T, tchol.tri_solve(l_one, b), upper=True)
    np.testing.assert_allclose(got, single.numpy(), rtol=0, atol=SOLVE_ATOL)
    np.testing.assert_allclose(worlds[p]["forward"], tchol.tri_solve(l_one, b).numpy(), rtol=0,
                               atol=SOLVE_ATOL)
    # Zero right-hand sides on the identity rows stay zero.
    np.testing.assert_allclose(got[~case["active"]], 0.0, atol=1e-6)


@pytest.mark.parametrize("p", MESHES)
def test_sharded_whiten_matches_jax_and_the_single_device_whitening(worlds, p):
    """L row-sharded, K column-sharded over the corpus; the prefix products
    against the reference's full-width ones."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ital_tpu.parallel.chol2d import make_sharded_whiten
    from ital_tpu.parallel.mesh import CORPUS_AXIS

    case = INPUTS["whiten"]
    got = worlds[p]["whiten"]
    mesh, l = _jax_factor(p, case)
    kx = jax.device_put(jnp.asarray(case["kx"]), NamedSharding(mesh, P(None, CORPUS_AXIS)))
    want = np.asarray(make_sharded_whiten(mesh)(l, kx))
    np.testing.assert_allclose(got, want, rtol=0, atol=SOLVE_ATOL)
    single = tchol.tri_solve(torch.from_numpy(_padded(case)), torch.from_numpy(case["kx"]))
    np.testing.assert_allclose(got, single.numpy(), rtol=0, atol=SOLVE_ATOL)


@pytest.mark.parametrize("p", MESHES)
def test_sharded_fit_pipeline_gives_the_gp_fit_mean(worlds, p):
    """The sharded factor and solve as a GP fit: mu == gp_update's mu, and
    the reference's pipeline on the same state."""
    import jax.numpy as jnp

    from ital_tpu.ops.kernels import rbf_kernel as jrbf
    from ital_tpu.parallel.chol2d import make_sharded_cho_solve, make_sharded_cholesky, shard_rows
    from ital_tpu.parallel.mesh import make_mesh as jmesh

    case = INPUTS["fit"]
    got = worlds[p]["fit_mu"]
    np.testing.assert_allclose(got, case["mu"], rtol=0, atol=MU_ATOL)
    mesh = jmesh(p)
    x, idx = jnp.asarray(case["x"]), jnp.asarray(case["idx"])
    active = jnp.asarray(case["active"])
    l = make_sharded_cholesky(mesh)(shard_rows(jrbf(x[idx], x[idx], 2.0, 1.0), mesh), active,
                                    jnp.float32(0.1))
    alpha = make_sharded_cho_solve(mesh)(l, jnp.where(active, jnp.asarray(case["y"]),
                                                      0.0)[:, None])[:, 0]
    want = jnp.where(active[:, None], jrbf(x[idx], x, 2.0, 1.0), 0.0).T @ alpha
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=MU_ATOL)


@pytest.mark.parametrize("p", MESHES)
def test_indivisible_cap_raises_the_reference_message(worlds, p):
    msg = worlds[p]["indivisible"]
    assert msg is not None and "divide evenly" in msg and f"{p}-device mesh" in msg


def test_sharded_cholesky_at_cap_512_on_four_ranks(worlds):
    """cap 512 over 4 ranks (128-row panels), the large labeled set the
    layout exists for: equal to the reference and to the padded factor."""
    case = INPUTS["big"]
    got = worlds[BIG_MESH]["big"]
    _, want = _jax_factor(BIG_MESH, case)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=FACTOR_ATOL)
    np.testing.assert_allclose(got, _padded(case), rtol=0, atol=FACTOR_ATOL)


def test_mesh_of_one_is_the_single_device_path():
    """One rank: one panel, the factor and solves of ``ops.chol``, and
    ``shard_rows`` a copy of the whole."""
    case = INPUTS["solve"]
    with make_mesh(1, device="cpu") as mesh:
        k = torch.from_numpy(case["k"])
        rows = chol2d.shard_rows(k, mesh)
        assert torch.equal(rows, k) and rows.data_ptr() != k.data_ptr()
        l = chol2d.make_sharded_cholesky(mesh)(rows, torch.from_numpy(case["active"]),
                                               case["noise"])
        np.testing.assert_allclose(l.numpy(), _padded(case), rtol=0, atol=1e-6)
        b = torch.from_numpy(case["b"])
        np.testing.assert_allclose(chol2d.solve2d_local(mesh, l, b).numpy(),
                                   tchol.tri_solve(l, b).numpy(), rtol=0, atol=1e-6)
        with pytest.raises(ValueError, match="divide evenly"):
            mesh.size = 3  # the layout of a mesh of 3, read only
            chol2d.shard_rows(k, mesh)
        mesh.size = 1

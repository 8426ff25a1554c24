"""The CUDA RBF kernels (both routes) against their plain version, and the
captured programs (``ital_tpu_torch.graphs``) against their eager runs, on a
card.

No JAX here, so this file also runs where only the port is installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Without a CUDA device every test skips.
"""

import numpy as np
import pytest
import torch

from ital_tpu_torch import graphs
from ital_tpu_torch.data import datasets as tds
from ital_tpu_torch.data.datasets import _synthetic_surrogate
from ital_tpu_torch.models.session import ActiveRetrieval
from ital_tpu_torch.ops import rbf_hopper
from ital_tpu_torch.ops.kernels import rbf_kernel, rbf_kernel_plain


@pytest.mark.cuda
@pytest.mark.parametrize("shape,norms,dtype", [
    ((64, 2500, 512), "b2", torch.float32),
    ((4, 2500, 512), "b2", torch.float32),
    ((2500, 3, 512), "a2", torch.float32),
    ((64, 64, 512), "none", torch.float32),
    ((100, 300, 8), "none", torch.float32),
    ((1, 1, 3), "none", torch.float32),
    ((64, 2500, 512), "b2", torch.bfloat16),
    ((100, 300, 8), "none", torch.bfloat16),
])
def test_cuda_kernel_matches_plain(shape, norms, dtype):
    """f32 within 1e-5 x var of the plain version; bf16 within 1e-4 x var of
    the plain version on the same bf16 values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    rng = np.random.default_rng(0)
    m, n, d = shape
    a = torch.from_numpy(rng.random((m, d), dtype=np.float32)).cuda().to(dtype)
    b = torch.from_numpy(rng.random((n, d), dtype=np.float32)).cuda().to(dtype)
    kw = {}
    if norms == "a2":
        kw["a2"] = (a.float() ** 2).sum(-1)
    if norms == "b2":
        kw["b2"] = (b.float() ** 2).sum(-1)
    ls = torch.tensor(float(np.sqrt(d)), device="cuda")
    before = rbf_hopper.LAUNCHES
    got = rbf_kernel(a, b, ls, 0.8, **kw)
    want = rbf_kernel_plain(a, b, ls, 0.8, **kw)
    torch.cuda.synchronize()
    assert rbf_hopper.LAUNCHES == before + 1
    atol = (1e-4 if dtype == torch.bfloat16 else 1e-5) * 0.8
    assert float((got - want).abs().max()) <= atol


def _inputs(shape, norms, dtype, seed=0):
    """Rows of the MIRFLICKR surrogate at width D (ReLU features, squared
    norms ~10 D), and ls = sqrt(5 D) (50 at D = 512, the production
    setting): dot products in the thousands, where one TF32 pass or a long
    tensor-core accumulation misses 1e-5 x var."""
    m, n, d = shape
    x = _synthetic_surrogate("mirflickr", m + n, d, 14, seed=seed).x
    a = torch.from_numpy(x[:m]).cuda().to(dtype)
    b = torch.from_numpy(x[m:]).cuda().to(dtype)
    kw = {}
    if norms in ("a2", "both"):
        kw["a2"] = (a.float() ** 2).sum(-1)
    if norms in ("b2", "both"):
        kw["b2"] = (b.float() ** 2).sum(-1)
    return a, b, kw, torch.tensor(float(np.sqrt(5 * d)), device="cuda")


def _atol(dtype, var):
    return (1e-4 if dtype == torch.bfloat16 else 1e-5) * var


@pytest.mark.cuda
@pytest.mark.parametrize("shape,norms,dtype", [
    ((300, 700, 512), "none", torch.float32),
    ((129, 257, 100), "none", torch.float32),
    ((2500, 300, 512), "both", torch.float32),
    ((64, 2500, 512), "b2", torch.float32),
    ((2500, 64, 512), "a2", torch.float32),
    ((64, 2500, 512), "b2", torch.bfloat16),
    ((200, 300, 64), "none", torch.bfloat16),
])
def test_cuda_tensor_core_route_matches_plain(shape, norms, dtype):
    """The tensor-core route (forced where the router would pick the tile
    kernel: D < 128 at these sizes) against the plain version with the tile
    kernel's tolerances (1e-5 x var f32 through 3xTF32, 1e-4 x var bf16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    a, b, kw, ls = _inputs(shape, norms, dtype)
    before = rbf_hopper.ROUTE_LAUNCHES["wgmma"]
    got = rbf_hopper.rbf_tile(a, b, ls, 0.8, _route="wgmma", **kw)
    want = rbf_kernel_plain(a, b, ls, 0.8, **kw)
    torch.cuda.synchronize()
    assert rbf_hopper.ROUTE_LAUNCHES["wgmma"] == before + 1
    assert float((got - want).abs().max()) <= _atol(dtype, 0.8)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,norms,dtype", [
    ((300, 700, 512), "none", torch.float32),
    ((100, 300, 8), "both", torch.float32),
    ((64, 2500, 512), "b2", torch.float32),
    ((2500, 48, 512), "a2", torch.float32),
    ((48, 40, 128), "none", torch.float32),
    ((16, 2500, 512), "none", torch.float32),
    ((200, 300, 64), "none", torch.bfloat16),
    ((2500, 3, 512), "none", torch.bfloat16),
])
def test_cuda_routes_agree(shape, norms, dtype):
    """Each route forced on a call both can take: within the tolerance of the
    other, and of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    a, b, kw, ls = _inputs(shape, norms, dtype, seed=2)
    wg = rbf_hopper.rbf_tile(a, b, ls, 0.8, _route="wgmma", **kw)
    tile = rbf_hopper.rbf_tile(a, b, ls, 0.8, _route="tile", **kw)
    want = rbf_kernel_plain(a, b, ls, 0.8, **kw)
    torch.cuda.synchronize()
    tol = _atol(dtype, 0.8)
    assert float((wg - tile).abs().max()) <= tol
    assert float((wg - want).abs().max()) <= tol
    assert float((tile - want).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,route", [
    ((2500, 2048, 512), torch.float32, "wgmma"),
    ((64, 2500, 512), torch.float32, "wgmma"),
    ((2500, 3, 512), torch.float32, "wgmma"),
    ((100, 300, 8), torch.float32, "tile"),
    ((64, 2500, 510), torch.float32, "tile"),
    ((64, 2500, 512), torch.bfloat16, "wgmma"),
])
def test_cuda_rbf_kernel_launches_the_chosen_route(shape, dtype, route):
    """rbf_kernel launches the route choose_route names, once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    a, b, kw, ls = _inputs(shape, "none", dtype, seed=4)
    assert rbf_hopper.choose_route(*shape, dtype, a.data_ptr(), b.data_ptr()).name == route
    before = dict(rbf_hopper.ROUTE_LAUNCHES)
    got = rbf_kernel(a, b, ls, 0.8)
    want = rbf_kernel_plain(a, b, ls, 0.8)
    torch.cuda.synchronize()
    after = dict(rbf_hopper.ROUTE_LAUNCHES)
    assert after == {r: before[r] + (r == route) for r in before}
    assert float((got - want).abs().max()) <= _atol(dtype, 0.8)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["wgmma", "tile"])
def test_cuda_scalars_by_value_or_on_device(route):
    """ls and var as Python numbers (passed by value), as 0-d f32 tensors on
    the card (read in place) and as other one-element tensors: one result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    a, b, _, _ = _inputs((128, 256, 64), "none", torch.float32, seed=3)
    by_value = rbf_hopper.rbf_tile(a, b, 8.0, 0.7, _route=route)
    on_device = rbf_hopper.rbf_tile(a, b, torch.tensor(8.0, device="cuda"),
                                    torch.tensor(0.7, device="cuda"), _route=route)
    other = rbf_hopper.rbf_tile(a, b, torch.tensor([8.0], device="cuda", dtype=torch.float64),
                                torch.tensor([[0.7]], device="cuda"), _route=route)
    torch.cuda.synchronize()
    assert torch.equal(by_value, on_device) and torch.equal(by_value, other)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("weighted", [False, True])
def test_cuda_blockwise_reduce_abs_kpost_matches_plain(dtype, weighted):
    """The EMOC column sums on the card, one kernel launch per candidate block,
    against the same function on the CPU's plain path, with and without
    positive weights w(x) <= 2.  Each |k_post| entry differs by a few f32 ulps
    of var; a column sums N of them (atol 4e-7 x N, times the largest weight);
    bf16 inputs are the same stored values on both sides."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from ital_tpu_torch.ops.kernels import blockwise_reduce_abs_kpost

    rng = np.random.default_rng(1)
    n, d, cap = 3000, 64, 24
    x = torch.from_numpy(rng.random((n, d), dtype=np.float32)).to(dtype)
    x2 = (x.float() ** 2).sum(-1)
    v = torch.from_numpy(rng.normal(scale=0.1, size=(cap, n)).astype(np.float32))
    cand = torch.arange(5, n, 3)
    w = torch.from_numpy(rng.uniform(0.1, 2.0, size=n).astype(np.float32)) if weighted else None
    want = blockwise_reduce_abs_kpost(x, v, cand, 4.0, 0.9, weights=w, x2=x2, block=256)
    before = rbf_hopper.LAUNCHES
    got = blockwise_reduce_abs_kpost(x.cuda(), v.cuda(), cand.cuda(), 4.0, 0.9,
                                     weights=None if w is None else w.cuda(), x2=x2.cuda(),
                                     block=256)
    torch.cuda.synchronize()
    assert rbf_hopper.LAUNCHES == before + -(-cand.shape[0] // 256)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5,
                               atol=4e-7 * n * (2.0 if weighted else 1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["wgmma", "tile"])
def test_cuda_kernel_writes_into_out(route):
    """``out=`` (the large-cap refit forms its cross block in ``v``'s own
    buffer): the kernel writes the given buffer, the values of a new block,
    one launch; ``rbf_kernel`` passes it through."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    a, b, kw, ls = _inputs((64, 2500, 512), "b2", torch.float32)
    want = rbf_hopper.rbf_tile(a, b, ls, 0.8, _route=route, **kw)
    out = torch.full((64, 2500), float("nan"), device="cuda")
    before = rbf_hopper.LAUNCHES
    got = rbf_hopper.rbf_tile(a, b, ls, 0.8, out=out, _route=route, **kw)
    torch.cuda.synchronize()
    assert got is out and rbf_hopper.LAUNCHES == before + 1
    assert torch.equal(out, want)
    again = torch.empty_like(out)
    assert rbf_kernel(a, b, ls, 0.8, out=again, **kw) is again
    assert float((again - rbf_kernel_plain(a, b, ls, 0.8, **kw)).abs().max()) <= _atol(
        torch.float32, 0.8)


@pytest.mark.cuda
def test_cuda_empty_output_launches_nothing():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    a = torch.zeros(0, 16, device="cuda")
    b = torch.ones(5, 16, device="cuda")
    before = rbf_hopper.LAUNCHES
    assert rbf_kernel(a, b, 1.0, 1.0).shape == (0, 5)
    assert rbf_hopper.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 64, 512), (17, 17, 8)])
def test_cuda_hyperparameter_gradient_through_the_kernel(shape):
    """The length scale's and the variance's gradients reach past the kernel
    (whose output has no autograd history of its own) and equal autograd
    through the plain version on the same card, to 1e-4 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    a, _, _, _ = _inputs(shape, "none", torch.float32)
    # A positive output gradient: no cancellation in the sums.
    g = torch.from_numpy(np.random.default_rng(3).uniform(0.5, 1.5, size=(shape[0], shape[0]))
                         .astype(np.float32)).cuda()
    grads = []
    for fn in (rbf_kernel, rbf_kernel_plain):
        ls = torch.tensor(float(np.sqrt(5 * shape[2])), device="cuda", requires_grad=True)
        var = torch.tensor(0.8, device="cuda", requires_grad=True)
        before = rbf_hopper.LAUNCHES
        (fn(a, a, ls, var) * g).sum().backward()
        torch.cuda.synchronize()
        assert rbf_hopper.LAUNCHES == before + (fn is rbf_kernel)
        grads.append((float(ls.grad), float(var.grad)))
    (ls_k, var_k), (ls_p, var_p) = grads
    assert ls_k != 0.0 and var_k != 0.0
    np.testing.assert_allclose([ls_k, var_k], [ls_p, var_p], rtol=1e-4)


@pytest.mark.cuda
def test_cuda_launch_count_is_exact_under_threads():
    """Launches from many threads at once are all counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    import sys
    import threading

    a = torch.rand(8, 16, device="cuda")
    before = rbf_hopper.LAUNCHES
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [rbf_kernel(a, a, 1.0, 1.0) for _ in range(200)])
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    torch.cuda.synchronize()
    assert rbf_hopper.LAUNCHES == before + 8 * 200


@pytest.mark.cuda
def test_cuda_stacked_select_and_update_match_the_cpu():
    """Three sessions stacked on the card, one with other hyperparameters:
    one stacked ITAL selection and one stacked GP update, run eagerly, launch
    the kernel once per block and hyperparameter group, pick the CPU's
    batches and reach the CPU's posterior means within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from ital_tpu_torch.models import gp as gp_mod
    from ital_tpu_torch.select.base import StrategyParams
    from ital_tpu_torch.select.ital import select_ital_stacked

    rng = np.random.default_rng(5)
    centers = rng.normal(size=(3, 128)) * 3.0
    x = np.concatenate([c + rng.normal(size=(300, 128)) for c in centers]).astype(np.float32)
    specs = [(3, 16.0, 1.0), (310, 16.0, 1.0), (620, 14.0, 0.9)]

    def sessions(dev):
        states = []
        for q, ls, var in specs:
            st = gp_mod.gp_init(torch.from_numpy(x).to(dev), ls, var, 0.1, 16)
            st = gp_mod.gp_set_query(st, q)
            picks = torch.tensor([q + 1, q + 2, (q + 300) % 900, (q + 600) % 900], device=dev)
            gp_mod.gp_update(st, picks, torch.tensor([1.0, 1.0, -1.0, -1.0], device=dev),
                             torch.ones(4, dtype=torch.bool, device=dev))
            states.append(st)
        return states

    kw = {"pool_size": 30, "n_qmc": 32, "refine_top": 8, "refine_n_qmc": 128}
    new_idx = torch.tensor([[5, 6, 7, 8], [311, 312, 400, 401], [621, 700, 10, 11]])
    new_y = torch.tensor([[1.0, 1.0, -1.0, 1.0], [1.0, -1.0, 1.0, 1.0], [1.0, 1.0, -1.0, -1.0]])
    out = {}
    for dev in ("cpu", "cuda"):
        states = sessions(dev)
        st = gp_mod.stack_states(states)
        assert st.hyper_groups == [[0, 1], [2]]
        params = StrategyParams.create(dev, label_prob=0.9, mistake_prob=0.05)
        before = rbf_hopper.LAUNCHES
        with graphs.eager():  # the graphed selection is held to this in a later test
            picks = select_ital_stacked(states, 4, [None] * 3, params, **kw)
        selected = rbf_hopper.LAUNCHES - before
        gp_mod.gp_update_stacked(st, new_idx.to(dev), new_y.to(dev),
                                 torch.ones(3, 4, dtype=torch.bool, device=dev))
        out[dev] = (picks.cpu(), st.mu.cpu(), selected, rbf_hopper.LAUNCHES - before - selected)
    torch.cuda.synchronize()
    picks_cpu, mu_cpu, _, _ = out["cpu"]
    picks_card, mu_card, selected, updated = out["cuda"]
    assert (selected, updated) == (2 * 2 * 3, 2 * 3)  # groups x blocks (x greedy steps 1-3)
    assert torch.equal(picks_card, picks_cpu)
    assert float((mu_card - mu_cpu).abs().max()) <= 1e-4


# The production selection (configs/mirflickr_production.ini) on a 3000-row
# surrogate: a pool of 256, n_qmc 32, the top 64 re-scored at 512.
GRAPH_KW = {"pool_size": 256, "n_qmc": 32, "refine_top": 64, "refine_n_qmc": 512}


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")


@pytest.mark.cuda
def test_cuda_graphed_session_equals_eager():
    """On the card: the captured fetch and update give the eager session's
    picks and a posterior within 1e-6; a second session replays them."""
    _needs_card()
    ds = tds._synthetic_surrogate("mirflickr", 3000, 128, 14, seed=0)
    x = torch.from_numpy(ds.x).cuda()
    kw = dict(length_scale=12.0, cap=32, label_prob=0.8, mistake_prob=0.05,
              method_kwargs=GRAPH_KW)
    graphed, plain = ActiveRetrieval(x, **kw), ActiveRetrieval(x, **kw)
    graphed.update_query(17)
    plain.update_query(17)
    before = graphs.captures()
    for _ in range(3):
        got = graphed.fetch_unlabelled(4)
        with graphs.eager():
            want = plain.fetch_unlabelled(4)
        np.testing.assert_array_equal(got, want)
        fb = {int(i): 1 for i in got}
        graphed.update(fb)
        with graphs.eager():
            plain.update(fb)
        assert float((graphed.state.mu - plain.state.mu).abs().max()) <= 1e-6
    assert graphs.captures() == before + 2  # the fetch and the update
    second = ActiveRetrieval(x, **kw)
    second.update_query(40)
    second.update({int(i): -1 for i in second.fetch_unlabelled(4)})
    assert graphs.captures() == before + 2


@pytest.mark.cuda
def test_cuda_replays_count_kernel_launches():
    """On the card every replay counts the kernel launches its capture
    recorded."""
    _needs_card()
    ds = tds._synthetic_surrogate("mirflickr", 3000, 128, 14, seed=1)
    sess = ActiveRetrieval(torch.from_numpy(ds.x).cuda(), length_scale=12.0, cap=32,
                           method_kwargs=GRAPH_KW)
    sess.update_query(3)
    sess.fetch_unlabelled(4)
    replays = {id(p): p.replays for p in graphs.programs()}
    before = rbf_hopper.LAUNCHES
    sess.fetch_unlabelled(4)
    (prog,) = [p for p in graphs.programs() if p.replays > replays.get(id(p), 0)]
    assert prog.name == "select_ital"
    assert rbf_hopper.LAUNCHES - before == sum(prog.launches.values()) > 0


@pytest.mark.cuda
def test_cuda_graphed_stacked_select_and_update_equal_eager():
    """On the card: the stacked ITAL selection and the stacked update of
    three sessions' own states (two hyperparameter groups, differing
    counts), each one captured program, give the picks of their
    ``graphs.eager()`` runs and bit-equal posteriors; the second round
    replays both programs."""
    _needs_card()
    from ital_tpu_torch.models import gp as gp_mod
    from ital_tpu_torch.select.base import StrategyParams
    from ital_tpu_torch.select.ital import select_ital_stacked

    ds = tds._synthetic_surrogate("mirflickr", 3000, 128, 14, seed=2)
    x = torch.from_numpy(ds.x).cuda()
    params = StrategyParams.create("cuda", label_prob=0.8, mistake_prob=0.05)
    states = []
    for q, ls, blocks in ((3, 12.0, 1), (1200, 10.0, 0), (2500, 12.0, 2)):
        st = gp_mod.gp_set_query(gp_mod.gp_init(x, ls, 1.0, 0.1, 32), q)
        for j in range(blocks):
            gp_mod.gp_update(st, torch.arange(4, device="cuda") + 10 * j + q % 7,
                             torch.tensor([1.0, -1.0, 1.0, -1.0], device="cuda"),
                             torch.ones(4, dtype=torch.bool, device="cuda"))
        states.append(st)
    twins = [gp_mod.gp_session_copy(s) for s in states]
    before = graphs.programs()  # held: a released program's id is not reused
    for r in range(2):
        picks = select_ital_stacked(states, 4, [None] * 3, params, **GRAPH_KW)
        with graphs.eager():
            want = select_ital_stacked(twins, 4, [None] * 3, params, **GRAPH_KW)
        assert torch.equal(picks, want), r
        y = torch.where(picks % 2 == 0, 1.0, -1.0)
        valid = torch.ones_like(picks, dtype=torch.bool)
        gp_mod.update_stacked(states, picks, y, valid)
        with graphs.eager():
            gp_mod.update_stacked(twins, want, y, valid)
        for a, b in zip(states, twins):
            assert a.count == b.count
            for f in gp_mod.SESSION_FIELDS:
                assert torch.equal(getattr(a, f), getattr(b, f)), (r, f)
    mine = [p for p in graphs.programs() if all(p is not q for q in before)]
    assert sorted(p.name for p in mine) == ["gp_update_stacked", "select_ital_stacked"]
    assert all(p.replays == 2 for p in mine)


@pytest.mark.cuda
def test_cuda_graphed_ascent_equals_eager_at_every_step():
    """On the card: the hyperparameter ascent as one captured program (the
    backward passes included) gives the eager ascent's gradient at every
    step and its learned values, also when replayed on a labeled set other
    than the one it was captured with; the stacked ascent of three sessions
    follows each session's own."""
    _needs_card()
    from ital_tpu_torch.models import hyperopt
    from ital_tpu_torch.models.gp import GPHyper

    ds = tds._synthetic_surrogate("mirflickr", 3000, 128, 14, seed=3)
    x = torch.from_numpy(ds.x).cuda()
    rng = np.random.default_rng(0)
    h0 = GPHyper(*(torch.tensor(v, device="cuda") for v in (12.0, 1.0, 0.1)))
    sets = []
    for _ in range(3):
        idx = torch.from_numpy(rng.choice(3000, 32, replace=False)).cuda()
        y = torch.from_numpy(np.where(rng.random(32) < 0.4, 1.0, -1.0).astype(np.float32)).cuda()
        active = torch.arange(32, device="cuda") < 25
        sets.append((x[idx], y, active))
    before = graphs.captures()
    for xl, y, active in sets[:2]:
        got, got_g = hyperopt.fit_with_gradients(xl, y, active, h0, steps=30, prior_strength=1.0)
        with graphs.eager():
            want, want_g = hyperopt.fit_with_gradients(xl, y, active, h0, steps=30,
                                                       prior_strength=1.0)
        rel = ((got_g - want_g).abs() / want_g.abs().clamp(min=1e-6)).max()
        assert float(rel) <= 1e-6 and bool((got_g != 0).all())
        for f in ("length_scale", "var", "noise"):
            a, b = float(getattr(got, f)), float(getattr(want, f))
            assert abs(a - b) <= 1e-6 * abs(b), f
    assert graphs.captures() == before + 1
    xl, y, active = (torch.stack(t) for t in zip(*sets))
    theta0 = hyperopt._log_theta(h0).expand(3, 3).contiguous()
    stacked = hyperopt.fit_hyperparams_stacked(xl, y, active, theta0, steps=30)
    for k in range(3):
        one = hyperopt.fit_hyperparams(xl[k], y[k], active[k], h0, steps=30)
        want = torch.log(torch.stack([one.length_scale, one.var, one.noise]))
        assert float((stacked[k] - want).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_cuda_stacked_regression_fetch_equals_the_left_side_solve(monkeypatch):
    """A stacked ``ital_regression`` fetch of 4 sessions over 100 000 rows:
    its (K, t, N) conditional-variance solves go through ``tri_solve`` (the
    right-side form on the card) and pick what the direct left-side solve
    picks, each solve within f32 rounding of the left-side values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ital_tpu_torch.models import gp as gp_mod
    from ital_tpu_torch.ops import chol as chol_ops
    from ital_tpu_torch.select.base import StrategyParams, get_stacked_strategy

    x = torch.from_numpy(_synthetic_surrogate("wide", 100_000, 64, 5).x).cuda()
    states = []
    for q in (3, 1000, 50_000, 99_000):
        st = gp_mod.gp_set_query(gp_mod.gp_init(x, 12.0, 1.0, 0.1, 16), q)
        gp_mod.gp_update(st, torch.tensor([q + 1, q - 2, 77], device="cuda"),
                         torch.tensor([1.0, -1.0, 1.0], device="cuda"),
                         torch.ones(3, dtype=torch.bool, device="cuda"))
        states.append(st)
    params = StrategyParams.create("cuda")
    select = get_stacked_strategy("ital_regression")
    real, gaps = chol_ops.tri_solve, []

    def held(l, b, *, trans=False):
        out = real(l, b, trans=trans)
        if not trans and b.shape[-1] == x.shape[0]:
            left = torch.linalg.solve_triangular(l, b, upper=False)
            gaps.append(float((out - left).abs().max() / left.abs().max()))
        return out

    def left_side(l, b, *, trans=False):
        if trans:
            return real(l, b, trans=trans)
        return torch.linalg.solve_triangular(l, b, upper=False)

    with graphs.eager():
        monkeypatch.setattr(chol_ops, "tri_solve", left_side)
        want = select(states, 4, [None] * 4, params)
        monkeypatch.setattr(chol_ops, "tri_solve", held)
        got = select(states, 4, [None] * 4, params)
    assert len(gaps) == 3 and max(gaps) <= 1e-5, gaps
    assert torch.equal(got, want)

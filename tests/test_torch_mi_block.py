"""The MI scan's default block (``select.ital.mi_block``) against the
reference's MI scan and across the port's callers.

``mi_block(m, n_qmc)`` is the largest block whose eager working set stays
within ``MI_EAGER_BYTES``, at most 32768.  Wherever the port ran before it (m <= 6
at the batch-size study's n_qmc over 25 000 rows, the production
configuration's base scan and re-scoring for a cohort of 8, the m = 4 full
scans up to 1M rows) the rows split into the blocks they took at 32768; at
m = 8 the block is smaller.  Scores do not depend on the block: at m = 8 the chosen
block, 32768 and 64 agree within 1e-6 (f32) and 1e-12 (f64), and all
three agree with ``ital_tpu``'s ``mi_scores_from_moments`` at its block
1024 within 1e-5 (f32, the two packages' f32 MI scans round apart, as in
``test_torch_ital.py``) and 1e-10 (f64).  The stacked selection takes its
block over the K sessions' rows together, the mesh's over its shard's
rows, each at every greedy step's m.

The mesh case spawns a gloo world of 2, whose ranks import this module, so
it imports neither ``jax`` nor ``ital_tpu`` at its top.
"""

import numpy as np
import pytest
import torch

from ital_tpu_torch.data.datasets import toy_gaussians
from ital_tpu_torch.models import gp as tgp
from ital_tpu_torch.parallel import launch, sharded as sh
from ital_tpu_torch.select import ital as tital
from ital_tpu_torch.select.base import StrategyParams

TODAY = 32768
# Where the port ran before the default became a function: (m, n_qmc, rows
# scored in one call), m over every greedy step's (t + 1).
KEEPS = (
    [(m, q, 25_000) for m in range(1, 7) for q in (128, 256)]  # batch_size_timing, m <= 6
    + [(m, 32, 8 * 4096) for m in range(1, 9)]  # production base scan, a cohort of 8 pools
    + [(m, 512, 8 * 64) for m in range(1, 9)]  # its re-scoring of the top 64, 8 sessions
    + [(m, q, 1_000_000) for m in range(1, 5) for q in (32, 128, 256)]  # m = 4 full scans
)
SAME_F32, SAME_F64, JAX_F32, JAX_F64 = 1e-6, 1e-12, 1e-5, 1e-10
LS, VAR, NOISE, CAP = 1.5, 1.0, 0.1, 16


def _row_bytes(m: int, n_qmc: int) -> int:
    """A candidate row's eager working set, as ``mi_block`` counts it."""
    return 2 * n_qmc * 2**m * (3 * m + 7)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("m,n_qmc,rows", KEEPS)
def test_where_the_port_ran_its_rows_keep_their_blocks(m, n_qmc, rows):
    """The configuration's rows split into the same blocks as at 32768."""
    assert min(tital.mi_block(m, n_qmc), rows) == min(TODAY, rows)


@pytest.mark.parametrize("m", range(1, 7))
def test_up_to_m6_at_n_qmc_128_the_block_is_32768(m):
    assert tital.mi_block(m, 128) == TODAY


@pytest.mark.parametrize("n_qmc", [128, 256])
def test_m8_takes_the_largest_block_within_the_budget(n_qmc):
    m = 8
    block = tital.mi_block(m, n_qmc)
    row = _row_bytes(m, n_qmc)
    assert block < TODAY and block % 256 == 0
    assert block * row <= tital.MI_EAGER_BYTES < (block + 256) * row


def test_a_tiny_budget_still_scores_one_row_a_block(monkeypatch):
    monkeypatch.setattr(tital, "MI_EAGER_BYTES", 1)
    assert tital.mi_block(8, 512) == 1


def _moments(dtype, m=8, rows=300, seed=0):
    rng = np.random.default_rng(seed)
    t = m - 1
    a = rng.normal(size=(m, m + 2)) / np.sqrt(m + 2)
    cov = a @ a.T + 0.2 * np.eye(m)
    return [np.asarray(v, dtype) for v in (
        rng.normal(size=rows) * 0.5, cov[t, t] + rng.uniform(0, 0.1, rows),
        cov[t, :t] + rng.normal(size=(rows, t)) * 0.05, rng.normal(size=t) * 0.5, cov[:t, :t])]


def _spy_blocks(monkeypatch):
    """Record each ``blocked_map`` call of the MI scan as (rows, t, block)."""
    seen = []
    inner = tital.blocked_map

    def spy(fn, arrays, *, block, pad_values=None):
        seen.append((arrays[0].shape[0], arrays[2].shape[1], block))
        return inner(fn, arrays, block=block, pad_values=pad_values)

    monkeypatch.setattr(tital, "blocked_map", spy)
    return seen


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_m8_scores_do_not_depend_on_the_block_and_match_jax(monkeypatch, dtype):
    import jax
    import jax.numpy as jnp

    from ital_tpu.select import ital as jital
    from ital_tpu.select.base import StrategyParams as JParams

    m, n_qmc = 8, 32
    # A budget whose block at m = 8 is 128 rows, so 300 rows take three blocks.
    monkeypatch.setattr(tital, "MI_EAGER_BYTES", int(128.5 * _row_bytes(m, n_qmc)))
    assert tital.mi_block(m, n_qmc) == 128
    seen = _spy_blocks(monkeypatch)
    arrays = _moments(dtype)
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    params = StrategyParams(**{k: torch.tensor(v, dtype=tdt) for k, v in (
        ("label_prob", 0.8), ("mistake_prob", 0.05), ("jitter", 1e-6), ("tradeoff", 0.5))})
    scores = {block: tital.mi_scores_from_moments(
        *(torch.from_numpy(a) for a in arrays), params, t=m - 1, n_qmc=n_qmc,
        block=block).numpy() for block in (None, TODAY, 64)}
    assert [b for *_, b in seen] == [128, TODAY, 64]
    same = SAME_F32 if dtype == np.float32 else SAME_F64
    np.testing.assert_allclose(scores[TODAY], scores[None], rtol=0, atol=same)
    np.testing.assert_allclose(scores[64], scores[None], rtol=0, atol=same)
    with jax.enable_x64(dtype == np.float64):
        jp = JParams(label_prob=jnp.asarray(0.8, dtype), mistake_prob=jnp.asarray(0.05, dtype))
        want = np.asarray(jital.mi_scores_from_moments(
            *(jnp.asarray(a) for a in arrays), jp, t=m - 1, n_qmc=n_qmc, block=1024))
    assert want.dtype == dtype
    for got in scores.values():
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=JAX_F32 if dtype == np.float32 else JAX_F64)


def test_an_explicit_block_overrides_the_default(monkeypatch):
    seen = _spy_blocks(monkeypatch)
    arrays = [torch.from_numpy(a) for a in _moments(np.float32, m=3, rows=40)]
    tital.mi_scores_from_moments(*arrays, StrategyParams.create("cpu", label_prob=0.8,
                                                                mistake_prob=0.05),
                                 t=2, n_qmc=16, block=16)
    assert seen == [(40, 2, 16)]


# -- the callers: the stacked selection and the mesh ----------------------------

M, N_QMC = 4, 16
# A budget whose blocks at n_qmc 16 are 8 rows at m = 4 and more below: a
# corpus of 225 rows (113 a shard) takes several blocks at the later steps.
SMALL_BUDGET = int(8.5 * _row_bytes(M, N_QMC))


def _warm_state(dtype=torch.float32, pad_to=None):
    ds = toy_gaussians(n_per_class=75, n_classes=3, dim=2, seed=5)  # 225 rows
    x = ds.x if pad_to is None else np.pad(ds.x, ((0, pad_to - ds.n), (0, 0)))
    state = tgp.gp_init(torch.from_numpy(x).to(dtype), LS, VAR, NOISE, CAP)
    state = tgp.gp_set_query(state, 4)
    picks = list(range(5, ds.n, 24))
    ys = torch.tensor([1.0 if ds.relevance[i, ds.labels[4]] else -1.0 for i in picks], dtype=dtype)
    return tgp.gp_update(state, torch.tensor(picks), ys, torch.ones(len(picks), dtype=torch.bool))


def _params():
    return StrategyParams.create("cpu", label_prob=0.9, mistake_prob=0.05)


def _expected(t: int) -> int:
    return tital.mi_block(t + 1, N_QMC)


def test_the_stacked_selection_blocks_the_sessions_rows_together(monkeypatch):
    monkeypatch.setattr(tital, "MI_EAGER_BYTES", SMALL_BUDGET)
    a, b = _warm_state(), _warm_state()
    b = tgp.gp_update(b, torch.tensor([7, 40]), torch.tensor([1.0, -1.0]),
                      torch.ones(2, dtype=torch.bool))
    singles = [tital.select_ital(s, M, None, _params(), n_qmc=N_QMC).tolist() for s in (a, b)]
    seen = _spy_blocks(monkeypatch)
    stacked = tital.select_ital_stacked([a, b], M, [None, None], _params(), n_qmc=N_QMC)
    assert stacked.tolist() == singles
    n = a.x.shape[0]
    assert [(rows, t) for rows, t, _ in seen] == [(2 * n, t) for t in range(M)]
    assert [blk for *_, blk in seen] == [_expected(t) for t in range(M)]
    assert seen[-1][2] < 2 * n  # the last steps take several blocks


def _rank_blocks(mesh, state_arrays, budget):
    """The sharded full-scan selection on this rank with the MI budget set
    to ``budget``: its picks and every MI scan's (rows, t, block)."""
    tital.MI_EAGER_BYTES = budget
    seen = []
    inner = tital.blocked_map

    def spy(fn, arrays, *, block, pad_values=None):
        seen.append((arrays[0].shape[0], arrays[2].shape[1], block))
        return inner(fn, arrays, block=block, pad_values=pad_values)

    tital.blocked_map = spy
    state = sh.shard_state(tgp.state_from_arrays(state_arrays, "cpu"), mesh)
    n_pad = state_arrays["x"].shape[0]
    sel_forbid, _ = sh.make_masks(n_pad, 225, 4)
    select = sh.make_sharded_select(mesh, batch_size=M, n_qmc=N_QMC)
    picks = select(state, None, sel_forbid, _params(), n_real=225)
    return {"picks": picks.tolist(), "seen": seen, "shard_rows": state.x.shape[0]}


def test_the_mesh_blocks_its_shard_rows(monkeypatch):
    monkeypatch.setattr(tital, "MI_EAGER_BYTES", SMALL_BUDGET)
    want = tital.select_ital(_warm_state(), M, None, _params(), n_qmc=N_QMC).tolist()
    arrays = tgp.state_to_arrays(_warm_state(pad_to=226))
    got = launch(2, _rank_blocks, arrays, SMALL_BUDGET, device="cpu")
    assert got["picks"] == want
    assert got["shard_rows"] == 113
    assert [(rows, t) for rows, t, _ in got["seen"]] == [(113, t) for t in range(M)]
    assert [blk for *_, blk in got["seen"]] == [_expected(t) for t in range(M)]
    assert got["seen"][-1][2] < 113


# -- room for a program that runs out of device memory (graphs.run) ----------


class _StandIn:
    """A graph that recomputes its body at each replay, as a graph rewrites
    its buffers."""

    def __init__(self, body, shared, buffers, outputs):
        self.body, self.shared, self.buffers, self.outputs = body, shared, buffers, outputs

    def replay(self):
        for out, val in zip(self.outputs, self.body(**self.shared, **self.buffers)):
            out.copy_(val)


def _out_of_memory(how: str):
    """What a capture raises when the device runs out: in its eager warm-up,
    or inside the capture itself (wrapped as ``CaptureError``)."""
    from ital_tpu_torch import graphs

    exc = torch.cuda.OutOfMemoryError("CUDA out of memory (stand-in)")
    if how == "warm-up":
        return exc
    wrapped = graphs.CaptureError("capturing failed: stand-in")
    wrapped.__cause__ = exc
    return wrapped


@pytest.fixture
def room(monkeypatch):
    """CPU tensors through the graph path with a stand-in capture that runs
    out of memory while ``room["full"](programs held)`` says so; yields the
    dict, whose ``"tries"`` lists each capture's name and the programs held
    at it."""
    from ital_tpu_torch import graphs

    state = {"full": lambda held: False, "how": "warm-up", "tries": []}

    def capture(name, body, buffers, shared, device, mesh):
        held = len(graphs._PROGRAMS)
        state["tries"].append((name, held))
        if state["full"](held):
            raise _out_of_memory(state["how"])
        with graphs._in_program() as checks:
            outputs = tuple(t.clone() for t in body(**shared, **buffers))
        return _StandIn(body, shared, buffers, outputs), outputs, checks, {}, 0.0, 0.0, 0.0

    monkeypatch.setattr(graphs, "_PROGRAMS", {})
    monkeypatch.setattr(graphs, "_STAGES", {})
    monkeypatch.setattr(graphs, "_POOLS", {})
    monkeypatch.setattr(graphs, "_GRAPH_DEVICES", ("cuda", "cpu"))
    monkeypatch.setattr(graphs, "_capture_graph", capture)
    yield state


@pytest.mark.parametrize("how", ["warm-up", "capture"])
def test_a_capture_out_of_memory_releases_the_programs_and_captures_again(room, how):
    """Two m = 4 full scans' programs are held; a third capture runs out of
    memory beside them, so it releases both and captures once more, with
    the picks the eager run gives.  The released programs capture again at
    their next call."""
    from ital_tpu_torch import graphs

    state = _warm_state()
    with graphs.eager():
        want = {q: tital.select_ital(state, M, None, _params(), n_qmc=q).tolist()
                for q in (8, 16, 32)}
    got = {q: tital.select_ital(state, M, None, _params(), n_qmc=q).tolist() for q in (8, 16)}
    assert len(graphs.programs()) == 2 and room["tries"] == [("select_ital", 0),
                                                             ("select_ital", 1)]
    released, captured = graphs.released_for_room(), graphs.captures()
    room["full"], room["how"] = (lambda held: held >= 2), how
    got[32] = tital.select_ital(state, M, None, _params(), n_qmc=32).tolist()
    assert got == want
    assert room["tries"][2:] == [("select_ital", 2), ("select_ital", 0)]
    assert graphs.released_for_room() == released + 2 and graphs.captures() == captured + 1
    assert len(graphs.programs()) == 1
    assert tital.select_ital(state, M, None, _params(), n_qmc=8).tolist() == want[8]
    assert graphs.captures() == captured + 2 and len(graphs.programs()) == 2


def test_a_capture_that_runs_out_alone_raises(room):
    """With no program to release, a capture that runs out of memory
    raises at once: it is not tried again."""
    from ital_tpu_torch import graphs

    room["full"] = lambda held: True
    with pytest.raises(torch.cuda.OutOfMemoryError):
        tital.select_ital(_warm_state(), M, None, _params(), n_qmc=8)
    assert room["tries"] == [("select_ital", 0)] and graphs.programs() == []


def test_a_second_failure_raises(room):
    """After the release, a capture that runs out again raises."""
    from ital_tpu_torch import graphs

    state = _warm_state()
    tital.select_ital(state, M, None, _params(), n_qmc=8)
    room["full"] = lambda held: True
    with pytest.raises(torch.cuda.OutOfMemoryError):
        tital.select_ital(state, M, None, _params(), n_qmc=16)
    assert room["tries"] == [("select_ital", 0), ("select_ital", 1), ("select_ital", 0)]
    assert graphs.programs() == []


def test_a_capture_out_of_memory_drops_the_stages_with_the_programs(room):
    """A capture that runs out of memory beside a stacked program releases
    it and drops the single-device stages with it; once more out of memory,
    the stacked program's capture makes its stage anew and binds that."""
    from ital_tpu_torch import graphs

    def total(a, w):
        return (a.sum(0) * w,)

    rows, w = [torch.arange(4.0) + j for j in range(3)], torch.ones(1)
    graphs.run("stacked", total, {"a": rows, "w": w})
    (old,) = graphs.stages()
    room["full"] = lambda held: held >= 1
    (out,) = graphs.run("other", lambda x: (x * 2,), {"x": torch.ones(3)})
    assert [p.name for p in graphs.programs()] == ["other"] and graphs.stages() == []
    (got,) = graphs.run("stacked", total, {"a": rows, "w": w})
    (new,) = graphs.stages()
    (prog,) = graphs.programs()
    assert new is not old and prog.stages == (new,)
    assert prog.inputs["a"].data_ptr() == new.buffer.data_ptr()
    assert torch.equal(got, torch.stack(rows).sum(0)) and torch.equal(out, torch.full((3,), 2.0))


def test_a_mesh_program_out_of_memory_releases_nothing(room):
    """A mesh program's ranks release only alike, so its capture that runs
    out of memory raises and leaves every program, the single-device ones
    included, where it was."""
    from ital_tpu_torch import graphs

    class Mesh:
        uid = 7

    state = _warm_state()
    tital.select_ital(state, M, None, _params(), n_qmc=8)
    held, released = graphs.programs(), graphs.released_for_room()
    room["full"] = lambda held: True
    x = torch.ones(3)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        graphs.run("mesh_body", lambda x: (x + 1,), {"x": x}, mesh=Mesh())
    assert graphs.programs() == held and graphs.released_for_room() == released
    assert room["tries"][-1] == ("mesh_body", 1)


@pytest.mark.parametrize("writes", [(), ("x",)])
def test_an_eager_call_out_of_memory_makes_room_unless_it_writes(room, writes):
    """Under ``graphs.eager()`` a call that runs out of device memory and
    writes no input releases the programs and runs once more; one that
    writes in place may have written part, so it raises."""
    from ital_tpu_torch import graphs

    tital.select_ital(_warm_state(), M, None, _params(), n_qmc=8)
    calls = []

    def body(x):
        calls.append(len(graphs.programs()))
        if graphs.programs():
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (stand-in)")
        return (x * 2,)

    x = torch.ones(3)
    with graphs.eager():
        if writes:
            with pytest.raises(torch.cuda.OutOfMemoryError):
                graphs.run("eager_body", body, {"x": x}, writes=writes)
            assert calls == [1] and len(graphs.programs()) == 1
        else:
            (out,) = graphs.run("eager_body", body, {"x": x})
            assert calls == [1, 0] and torch.equal(out, 2 * x) and graphs.programs() == []


def test_the_mesh_options_default_to_the_function():
    assert sh._ital_options()["block"] is None


@pytest.mark.cuda
def test_the_default_block_s_eager_working_set_stays_within_its_budget():
    """On the card: one MI scan of ``mi_block(8, 128)`` rows peaks within
    the eager budget, and its capture replays the eager scores bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the measurement is the card's)")
    m, n_qmc = 8, 128
    rows = tital.mi_block(m, n_qmc)
    dev = torch.device("cuda")
    arrays = [torch.from_numpy(a).to(dev) for a in _moments(np.float32, m=m, rows=rows)]
    params = StrategyParams.create(dev, label_prob=0.8, mistake_prob=0.05)

    def call():
        return tital.mi_scores_from_moments(*arrays, params, t=m - 1, n_qmc=n_qmc)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    eager = call()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.empty_cache()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    assert peak <= tital.MI_EAGER_BYTES


@pytest.mark.cuda
def test_a_capture_that_does_not_fit_beside_a_held_program_makes_room():
    """On the card: a program whose temporary takes 55 % of the free device
    memory is held (its pool keeps the block); a second such program's
    warm-up runs out of memory beside it, so ``graphs.run`` releases the
    first and captures the second; the first captures again at its next
    call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the out-of-memory error is the card's)")
    from ital_tpu_torch import graphs

    dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    n = int(0.55 * torch.cuda.mem_get_info(dev)[0]) // 4  # f32 elements of 55 % of what is free

    def body(x):
        return (x.new_ones(n).mul_(x)[-1:].clone(),)

    before, captures = graphs.released_for_room(), graphs.captures()
    twos = torch.full((1,), 2.0, device=dev)
    assert graphs.run("room_a", body, {"x": twos})[0].item() == 2.0
    held = len(graphs.programs())
    assert graphs.run("room_b", body, {"x": twos + 1})[0].item() == 3.0
    assert graphs.released_for_room() - before == held
    assert [p.name for p in graphs.programs()] == ["room_b"]
    assert graphs.run("room_a", body, {"x": twos})[0].item() == 2.0
    assert graphs.captures() == captures + 3
    graphs._release_for_room()

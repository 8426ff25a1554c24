"""The port at the JAX package's largest scale, held at small sizes on the CPU.

The bfloat16 corpus on the serving and harness paths against ``ital_tpu``
(the cohort server on ``corpus100k`` with the fast selection, the runner on
shared draws), bfloat16 rounding bit for bit against the reference's host
rounding, the two 1M-row scripts (``scripts/scale1m_torch.py``,
``scripts/serve_throughput_torch.py``) at 4096 rows, and the kernel
wrapper's launch-geometry check.  The reference's packages are imported
inside the test bodies.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ital_tpu_torch import graphs
from ital_tpu_torch.models import gp as tgp
from ital_tpu_torch.ops import rbf_hopper
from ital_tpu_torch.serve import RetrievalService

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

FAST = {"n_qmc": 32, "refine_top": 64, "refine_n_qmc": 512}
MI_TIE_RTOL = 1e-5
MU_ATOL = 1e-4  # tests/test_torch_gp.py::_assert_states_close


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _bits(a) -> np.ndarray:
    """The 16 bits of each bfloat16 value of ``a`` (a NumPy array or a tensor)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _rounding_cases() -> np.ndarray:
    """Float32 values whose rounding to bfloat16 is decided by every case of
    round-to-nearest-even: low halves below, at and above the halfway point
    under even and odd high halves, carries into the exponent, signed zeros,
    subnormals, the largest finite values and infinities."""
    rng = np.random.default_rng(0)
    hi = np.array([0x3F80, 0x3F81, 0xBF80, 0xBF81, 0x7F7F, 0xFF7F, 0x0000, 0x8000, 0x0001,
                   0x007F, 0x3FFF, 0x4049, 0x7F80, 0xFF80], np.uint32)
    lo = np.array([0x0000, 0x0001, 0x7FFF, 0x8000, 0x8001, 0xFFFF], np.uint32)
    crafted = ((hi[:, None] << 16) | lo[None, :]).ravel().view(np.float32)
    crafted = crafted[~np.isnan(crafted)]  # NaN payloads are not part of the rule
    drawn = (rng.normal(size=4096) * rng.choice([1e-30, 1e-3, 1.0, 50.0, 1e30], 4096))
    return np.concatenate([crafted, drawn.astype(np.float32)])


def test_bfloat16_rounding_is_bit_equal_to_the_references_host_rounding():
    """The port rounds the corpus where it lies (``gp_init``, the service's
    ``.to(bfloat16)``), the reference on the host with NumPy
    (``ital_tpu/serve.py``): both are round-to-nearest-even, bit for bit.
    The norms are f32 sums of the stored values."""
    import jax.numpy as jnp

    x = _rounding_cases()
    host = x.astype(jnp.dtype("bfloat16"))
    ported = torch.from_numpy(x).to(torch.bfloat16)
    np.testing.assert_array_equal(_bits(ported), _bits(host))

    finite = np.nan_to_num(x, posinf=1.0, neginf=-1.0).clip(-1e30, 1e30)
    corpus = finite[: len(finite) // 4 * 4].reshape(-1, 4)
    st = tgp.gp_init(torch.from_numpy(corpus), 1.0, 1.0, 0.1, 4, corpus_dtype="bfloat16")
    np.testing.assert_array_equal(_bits(st.x), _bits(corpus.astype(jnp.dtype("bfloat16"))))
    stored = st.x.to(torch.float32)
    assert st.x2.dtype == torch.float32 and torch.equal(st.x2, (stored * stored).sum(-1))


def _tie_gap(state, theirs, ours, params) -> float:
    """Where the batch ``ours`` first parts from ``theirs`` (both picked on
    the reference's ``state``), the relative gap between the refined MI of
    the two picks of that step, the shared earlier picks as the partial
    batch, as the reference scores them; 0 where they agree."""
    import jax.numpy as jnp
    from ital_tpu.select import ital as jital

    t = next((t for t in range(len(theirs)) if theirs[t] != ours[t]), None)
    if t is None:
        return 0.0
    pair = jnp.asarray([theirs[t], ours[t]], jnp.int32)
    if t:
        mu_b, cov_bb, cross, sig2 = jital._joint_posterior(
            state, jnp.asarray(theirs, jnp.int32), t, params.jitter)
        cross = cross[pair]
    else:
        dt = state.mu.dtype
        mu_b, cov_bb, cross = jnp.zeros((0,), dt), jnp.zeros((0, 0), dt), jnp.zeros((2, 0), dt)
        sig2 = state.sig2 + params.jitter
    mi = np.asarray(jital.mi_scores_from_moments(state.mu[pair], sig2[pair], cross, mu_b, cov_bb,
                                                 params, t=t, n_qmc=FAST["refine_n_qmc"]),
                    np.float64)
    return float(abs(mi[0] - mi[1]) / np.abs(mi).max())


def test_bfloat16_cohort_service_answers_like_the_jax_service():
    """Four sessions of the bfloat16 service on ``corpus100k(n=4096,
    dim=64)`` with the fast selection over a pool of 1024, three rounds of
    ``/batch_select`` and ``/batch_feedback`` against the reference's
    service: the one corpus copy bit-equal, each batch equal to the
    reference's up to MI ties (relative refined-MI gap at the first parting
    within 1e-5, the reference scoring its own state), every posterior mean
    within 1e-4.  Both absorb the reference's batches, so their states stay
    comparable after a tie."""
    import jax.numpy as jnp
    from ital_tpu import serve as jserve
    from ital_tpu.data.datasets import corpus100k as jcorpus100k
    from ital_tpu.select.base import StrategyParams as JaxParams
    from ital_tpu_torch.data.datasets import corpus100k

    ds = corpus100k(n=4096, dim=64)
    np.testing.assert_array_equal(ds.x, jcorpus100k(n=4096, dim=64).x)
    kw = dict(length_scale=30.0, var=1.0, noise=0.1, cap=32, strategy="ital", label_prob=0.8,
              mistake_prob=0.05, method_kwargs={**FAST, "pool_size": 1024},
              corpus_dtype="bfloat16")
    jsvc = jserve.RetrievalService(ds.x, **kw)
    tsvc = RetrievalService(ds.x, device="cpu", **kw)
    np.testing.assert_array_equal(_bits(tsvc.x), _bits(np.asarray(jsvc.x)))
    params = JaxParams(label_prob=jnp.asarray(0.8), mistake_prob=jnp.asarray(0.05))
    queries = [int(q) for q in np.random.default_rng(0).choice(ds.n, 4, replace=False)]
    sids = {}
    for svc in (jsvc, tsvc):
        sids[svc] = [svc.create_session() for _ in queries]
        for sid, q in zip(sids[svc], queries):
            svc.set_query(sid, q)
    parted = 0
    for r in range(3):
        states = [jsvc._entry(sid)[0].state for sid in sids[jsvc]]
        want = jsvc.next_batch_many(sids[jsvc], 4)
        got = tsvc.next_batch_many(sids[tsvc], 4)
        for k, (state, a, b) in enumerate(zip(states, sids[jsvc], sids[tsvc])):
            if got[b] != want[a]:
                parted += 1
                gap = _tie_gap(state, want[a], got[b], params)
                assert gap <= MI_TIE_RTOL, (r, k, want[a], got[b], gap)
        answers = [{str(i): (1 if ds.labels[i] == ds.labels[q] else -1) for i in want[a]}
                   for a, q in zip(sids[jsvc], queries)]
        for svc in (jsvc, tsvc):
            assert svc.feedback_many(dict(zip(sids[svc], answers))) == {
                sid: {"labeled": 1 + 4 * (r + 1)} for sid in sids[svc]}
        for a, b in zip(sids[jsvc], sids[tsvc]):
            np.testing.assert_allclose(tsvc._entry(b)[0].state.mu.numpy(),
                                       np.asarray(jsvc._entry(a)[0].state.mu), atol=MU_ATOL)
    assert parted < 12  # most batches agree outright


@pytest.mark.parametrize("method_kwargs", [
    {"pool_size": 40, "n_qmc": 16},
    {"pool_size": 30, "n_qmc": 32, "refine_top": 8, "refine_n_qmc": 128},
], ids=["pool", "pool+refine"])
def test_bfloat16_runner_curve_equals_jax_on_shared_draws(method_kwargs, monkeypatch):
    """The counterpart of ``tests/test_corpus_dtype.py::test_end_to_end_learns``
    with a candidate pool: the port's runner at ``GP.corpus_dtype=bfloat16``,
    fed the reference's draws, gives ``ital_tpu.runner.run_experiment``'s AP
    curves (atol 1e-6) and learns past the random floor."""
    from ital_tpu import runner as jrunner
    from ital_tpu.utils import config as jconfig
    from ital_tpu_torch import runner as trunner
    from ital_tpu_torch.utils import config as tconfig
    from tests.test_torch_runner import _cfg, jax_round_draws

    kw = dict(gp={"corpus_dtype": "bfloat16", "cap": 24}, method_kwargs=method_kwargs,
              label_prob=0.8, mistake_prob=0.1, n_rounds=6, repetitions=2, batch_size=3)
    want = jrunner.run_experiment(_cfg(jconfig, "ital", **kw))
    monkeypatch.setattr(trunner, "round_draws", jax_round_draws)
    got = trunner.run_experiment(_cfg(tconfig, "ital", **kw), device="cpu")
    np.testing.assert_allclose(got["ap"], want["ap"], atol=1e-6)
    assert got["map"][-1] > 0.5


def _keys(record: dict, prefix: str = "") -> set:
    """Every key of ``record``, nested ones as ``outer.inner``."""
    out = set()
    for k, v in record.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, f"{prefix}{k}.")
    return out


def test_scale1m_script_writes_every_key_of_the_reference_record(tmp_path):
    """``scripts/scale1m_torch.py --device cpu`` at 4096 rows writes every key
    of ``results/scale1m.json`` (nested ones too), the device fields, finite
    times and an AP curve of the first and seven steady rounds; on the CPU
    no device memory is reported."""
    import scale1m_torch

    out = tmp_path / "scale.json"
    assert scale1m_torch.main(["--device", "cpu", "--n", "4096", "--reps", "1",
                               "--out", str(out)]) == 0
    got = json.loads(out.read_text())
    want = json.loads((ROOT / "results" / "scale1m.json").read_text())
    assert _keys(want) <= _keys(got)
    assert got["device"] == "cpu" and got["power_limit"] is None and got["platform"] == "cpu"
    assert got["n"] == 4096 and got["cap"] == 64 and got["pool"] == 4096
    assert got["device_mem_mb_peak"] is None and got["device_mem_mb_after_fit"] is None
    assert len(got["ap_curve"]) == 1 + got["full_round_ms"]["steady_rounds"]
    assert all(0 <= a <= 1 for a in got["ap_curve"])
    for mode in ("select_full", "select_pool4096"):
        assert got[mode]["ms_per_round"] > 0 and got[mode]["eager_ms_per_round"] > 0


@pytest.mark.parametrize("env,record", [
    ({"SERVE_TP_CORPUS": "corpus1m", "SERVE_TP_FASTSEL": "1",
      "SERVE_TP_CORPUS_DTYPE": "bfloat16"}, "serve_throughput_corpus1m_fastsel_bfloat16.json"),
    ({"SERVE_TP_CORPUS": "corpus100k", "SERVE_TP_FASTSEL": "1"},
     "serve_throughput_corpus100k_fastsel.json"),
], ids=["corpus1m_fastsel_bfloat16", "corpus100k_fastsel"])
def test_serve_throughput_script_writes_every_key_of_the_reference_record(
        tmp_path, monkeypatch, env, record):
    """``scripts/serve_throughput_torch.py --device cpu`` at 4096 rows writes
    every key of the reference's record for the same switches, the device
    fields and the same method options, under a name of its own."""
    import serve_throughput_torch

    monkeypatch.delenv("SERVE_TP_CORPUS_DTYPE", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    out = tmp_path / "serve.json"
    assert serve_throughput_torch.main(["--device", "cpu", "--n", "4096", "--reps", "1",
                                        "--out", str(out)]) == 0
    got = json.loads(out.read_text())
    want = json.loads((ROOT / "results" / record).read_text())
    assert _keys(want) <= _keys(got)
    assert got["method_kwargs"] == want["method_kwargs"]
    assert got.get("corpus_dtype") == want.get("corpus_dtype")
    assert got["device"] == "cpu" and got["power_limit"] is None and got["k_sessions"] == 8
    name = serve_throughput_torch.report_name(env["SERVE_TP_CORPUS"], got["method_kwargs"],
                                              env.get("SERVE_TP_CORPUS_DTYPE", ""))
    assert name == "serve_throughput_torch_" + record[len("serve_throughput_"):]


@pytest.mark.parametrize("script", ["scale1m_torch.py", "serve_throughput_torch.py"])
def test_scripts_exit_nonzero_without_a_card(script, tmp_path):
    """Without ``--device cpu`` and with no CUDA device, each script stops
    before it builds anything and writes no report."""
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "", "HOME": str(tmp_path),
           "SERVE_TP_CORPUS": "corpus1m"}
    res = subprocess.run([sys.executable, str(ROOT / "scripts" / script), "--n", "64"],
                         capture_output=True, text=True, timeout=120, env=env, cwd=tmp_path)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert "building" not in res.stdout and not list(tmp_path.glob("*.json"))


# --- the kernel's launch geometry at 1M rows -----------------------------------


@pytest.mark.parametrize("m,n,route,grid", [
    (64, 1_000_000, ("wgmma", 1, False), (1, 7813)),  # gp_fit's (cap, N)
    (4, 1_000_000, ("wgmma", 1, False), (1, 7813)),  # the update's (b, N)
    (1_000_000, 3, ("wgmma", 1, True), (1, 7813)),  # the full scan's (N, t)
    (4096, 3, ("wgmma", 1, True), (1, 32)),  # the pool's cross block
    (1_000_000, 2048, ("wgmma", 0, False), (16, 7813)),  # EMOC's column block
])
def test_launch_grid_at_the_1m_shapes(m, n, route, grid):
    """The router's plan and the grid the sources launch at the 1M-row
    path's blocks: the long side's tiles on y, far below 65535."""
    r = rbf_hopper.choose_route(m, n, 512, torch.float32, 0, 0)
    assert tuple(r) == route
    assert rbf_hopper.launch_grid(r, m, n) == grid
    rbf_hopper.check_launch(r, m, n, 512)
    tile = rbf_hopper.Route("tile")
    assert max(rbf_hopper.launch_grid(tile, m, n)) <= 15625  # 1M rows / 64
    rbf_hopper.check_launch(tile, m, n, 512)


@pytest.mark.parametrize("route,m,n,d", [
    (rbf_hopper.Route("wgmma", 1, False), 4, 65535 * 128 + 1, 512),
    (rbf_hopper.Route("wgmma", 0, False), 10_000_000, 2048, 512),
    (rbf_hopper.Route("tile"), 4_200_000, 64, 512),
    (rbf_hopper.Route("tile"), 64, 4, 2**31),
], ids=["wgmma-slab", "wgmma-tile", "tile", "int32"])
def test_launch_check_raises_before_a_grid_cuda_would_refuse(route, m, n, d):
    """Past 8.39M rows on the tensor-core route, 4.19M on the tile kernel, or
    an extent past int32, the wrapper raises on the host before any launch:
    this code runs on the CPU too."""
    with pytest.raises(ValueError, match="rbf_tile"):
        rbf_hopper.check_launch(route, m, n, d)


def test_stacked_pair_of_programs_is_kept_when_their_bytes_fit(monkeypatch):
    """A ``/batch_select`` of 8 and a ``/batch_feedback`` of 8 hold two
    stacked programs (stand-in graph), which bind one set of stages between
    them.  With ``graphs.STACK_BYTES`` at that set's bytes (at 1M rows and
    cap 64 about 2.1e9 bytes of the 4 GiB, where the two programs' own
    stacks held 4.23e9) the second round replays both and captures nothing;
    with room for less than the set they still share it, and neither
    releases the other, where their own stacks evicted each other."""
    from tests.test_torch_graphs import _StandInGraph
    from ital_tpu_torch.data.datasets import corpus100k

    def capture_graph(name, body, buffers, shared, device, mesh):
        with rbf_hopper.recording_launches() as launches, graphs._in_program() as checks:
            outputs = tuple(t.clone() for t in body(**shared, **buffers))
        return (_StandInGraph(body, shared, buffers, outputs, checks), outputs, checks,
                launches, 0.0, 0.0, 0.0)

    monkeypatch.setattr(graphs, "_PROGRAMS", {})
    monkeypatch.setattr(graphs, "_STAGES", {})
    monkeypatch.setattr(graphs, "_GRAPH_DEVICES", ("cuda", "cpu"))
    monkeypatch.setattr(graphs, "_capture_graph", capture_graph)
    ds = corpus100k(n=1024, dim=32)
    svc = RetrievalService(ds.x, length_scale=30.0, cap=32, label_prob=0.8, mistake_prob=0.05,
                           method_kwargs={**FAST, "pool_size": 256}, corpus_dtype="bfloat16",
                           device="cpu")
    sids = [svc.create_session() for _ in range(8)]
    for i, sid in enumerate(sids):
        svc.set_query(sid, 100 * i)

    def cohort_round() -> int:
        """One round of both requests; the captures it made."""
        before = graphs.captures()
        picks = svc.next_batch_many(sids, 4)
        svc.feedback_many({sid: {str(i): 1 for i in picks[sid]} for sid in sids})
        return graphs.captures() - before

    assert cohort_round() == 2
    held = {p.name: p for p in graphs.programs() if p.stacks}
    assert sorted(held) == ["gp_update_stacked", "select_ital_stacked"]
    select, update = held["select_ital_stacked"], held["gp_update_stacked"]
    assert select.stages == update.stages
    assert select.inputs["v"].data_ptr() == update.inputs["v"].data_ptr()
    size = sum(stage.nbytes for stage in graphs.stages())
    for budget in (size, size // 2):
        graphs._PROGRAMS.clear()
        graphs._STAGES.clear()
        monkeypatch.setattr(graphs, "STACK_BYTES", budget)
        assert [cohort_round() for _ in range(3)] == [2, 0, 0], budget

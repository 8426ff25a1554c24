"""The port's selection-config studies against the reference's study scripts.

* ``study_torch.mid_session_state`` is the reference's timing state
  (``scripts/pool_sweep.py::_mid_session_state`` and ``bench.build_state``);
* each timing script (``pool_refine_torch``, ``refine_study_torch``,
  ``pool_sweep_torch``, ``batch_size_timing_torch``, ``block_sweep_torch``)
  times the reference's configuration rows, with the same ``select_ital``
  options in the same order, and its record holds the reference's keys;
* each MAP script (``pool_refine_torch``, ``pool_sweep_torch``,
  ``randomize_qmc_study_torch``) hands the runner the reference's
  configurations and builds the reference's entries and ``paired`` entry;
* fed the reference's user draws from a file of
  ``scripts/jax_reference.py draws``, ``pool_refine_torch``'s MAP half gives the
  reference's curves on the MIRFLICKR surrogate's generator cut to
  1500 x 128;
* the committed draws file holds ``jax_round_draws`` for the reference's
  sessions, and ``--user-draws`` refuses a file that lacks a session;
* at the full 25 000 x 512 surrogate the two packages' first greedy picks
  differ only within f32 rounding of the maximal MI.
* the row ``chip_smoke.py`` times of each script (its ``SMOKE_ROW``) is
  one the script times; a batch-size row out of device memory is recorded
  as its error and not timed again;
* ``tie_order_study_torch`` moves each row's features, relevance, query
  and user draws together, leaves every row's MI bit for bit, and pairs
  each order with the reference's CPU and TPU records; ``--phi f32`` is
  the reference's f32 erfc up to rounding, set for the run's block only;
* ``jax_reference.py orders`` runs the reference on reordered rows with
  each session's own query row and key, and pairs with a port record.
"""

import dataclasses
import importlib.util
import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts"
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(SCRIPTS))

import batch_size_timing_torch as bst  # noqa: E402
import block_sweep_torch as bsw  # noqa: E402
import jax_reference as jref  # noqa: E402
import method_comparison_torch as mct  # noqa: E402
import pool_refine_torch as prt  # noqa: E402
import pool_sweep_torch as pst  # noqa: E402
import randomize_qmc_study_torch as rqt  # noqa: E402
import refine_study_torch as rst  # noqa: E402
import study_torch as st  # noqa: E402

DRAWS = ROOT / "results" / "jax_user_draws_mirflickr_s0-7_torch.npz"
MIRFLICKR = str(ROOT / "configs" / "mirflickr.ini")
CUT = ("EXPERIMENT.dataset=corpus100k", "DATA.n=1500", "DATA.dim=128", "DATA.n_classes=14")
CPU = {"device": "cpu", "power_limit": None}


def _reference(name: str):
    """A reference script under ``scripts/`` as a module (never run as main)."""
    spec = importlib.util.spec_from_file_location(f"ref_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cut(pkg: str, n: int = 1500, dim: int = 128):
    """The MIRFLICKR surrogate's generator at ``n`` x ``dim`` in ``pkg``."""
    mod = importlib.import_module(f"{pkg}.data.datasets")
    return mod.corpus100k(n=n, dim=dim, n_classes=14)


# ---------------------------------------------------------------------------
# The timing workload and the timing helper
# ---------------------------------------------------------------------------


def test_mid_session_state_is_the_reference_state():
    import bench

    ref = _reference("pool_sweep")
    # At the workload's 512 features: narrower rows make every kernel value
    # near var, and the fit's conditioning turns last-ulp differences of the
    # kernel blocks into ~1e-4 in mu.
    tds, jds = _cut("ital_tpu_torch", 1200, 512), _cut("ital_tpu", 1200, 512)
    got = st.mid_session_state(tds, torch.device("cpu"))
    want = ref._mid_session_state(jds, st.LS, st.VAR, st.NOISE)
    idx, ys = bench._labeled_history(jds, np.random.default_rng(7))
    also = bench.build_state(jds, idx, ys)
    assert got.count == int(want.count) == int(also.count) == 1 + 5 * st.BATCH
    assert got.cap == want.idx.shape[0] == st.CAP
    for w in (want, also):
        np.testing.assert_array_equal(got.idx.numpy(), np.asarray(w.idx))
        np.testing.assert_array_equal(got.y.numpy(), np.asarray(w.y))
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(w.valid))
        np.testing.assert_allclose(got.mu.numpy(), np.asarray(w.mu), atol=1e-5)
        np.testing.assert_allclose(got.sig2.numpy(), np.asarray(w.sig2), atol=1e-5)


def test_time_call_reports_both_modes_and_the_first_call():
    from ital_tpu_torch.models import gp as gp_mod

    state = st.mid_session_state(_cut("ital_tpu_torch", 400, 32), torch.device("cpu"))
    rows = st.time_selects(torch, torch.device("cpu"), state,
                           [("pool", {"n_qmc": 16, "pool_size": 64})], log=lambda s: None)
    r = rows["pool"]
    for mode in ("", "eager_"):
        assert r[f"{mode}ms_per_round"] > 0 and len(r[f"{mode}ms_trials"]) == 3
        assert r[f"{mode}ms_per_round"] == sorted(r[f"{mode}ms_trials"])[1]
        assert 1 <= r[f"{mode}calls_per_trial"] <= 50
    assert r["first_call_s"] > 0 and r["captures"] == 0 and r["launches_per_call"] == 0
    assert isinstance(state, gp_mod.GPState)


# ---------------------------------------------------------------------------
# The timing scripts hold the reference's rows and keys
# ---------------------------------------------------------------------------


def _fake_ds(n):
    return types.SimpleNamespace(n=n, x=np.zeros((1, 512), np.float32))


def _reference_timing(monkeypatch, tmp_path, name: str) -> tuple[dict, list]:
    """The reference script's timing record and its ``select_ital`` calls
    ``(batch, options)``, in order, with the timing and the state stubbed
    (nothing is written under ``results/``)."""
    import jax
    import jax.numpy as jnp

    import bench
    from ital_tpu.data import datasets
    from ital_tpu.select import ital as jital

    calls = []

    def select_ital(state, batch, key, params, **kw):
        calls.append((batch, kw))
        return jnp.zeros(batch, jnp.int32)

    def measure(select, state):
        select(state, jax.random.PRNGKey(0))
        return 1.5, 0.25

    monkeypatch.setattr(jital, "select_ital", select_ital)
    monkeypatch.setattr(datasets, "mirflickr", lambda: _fake_ds(25000))
    monkeypatch.setattr(datasets, "corpus100k", lambda **kw: _fake_ds(100_000))
    monkeypatch.setattr(bench, "_corpus", lambda: _fake_ds(25000))
    monkeypatch.setattr(bench, "_labeled_history", lambda ds, rng: ([], []))
    monkeypatch.setattr(bench, "build_state", lambda ds, idx, ys: None)
    import scripts.timing_protocol as tp

    monkeypatch.setattr(tp, "measure_select", measure)
    ref = _reference(name)
    (tmp_path / "results").mkdir(exist_ok=True)
    for attr, value in (("measure_select", measure), ("_mid_session_state", lambda *a: None),
                        ("_state", lambda ds: None), ("REPO", str(tmp_path)),
                        ("OUT", str(tmp_path / "results" / "out.json"))):
        if hasattr(ref, attr):
            monkeypatch.setattr(ref, attr, value)
    if name in ("pool_refine", "refine_study"):
        record = ref.run_timing(False)
    elif name == "pool_sweep":
        ref.run_timing(False)
        record = json.loads((tmp_path / "results" / "pool_sweep.json").read_text())
    else:
        monkeypatch.setattr(sys, "argv", [f"{name}.py"])
        assert ref.main() == 0
        out = "out.json" if name == "block_sweep" else f"{name}.json"
        record = json.loads((tmp_path / "results" / out).read_text())
    return record, calls


def _port_timing(monkeypatch, tmp_path, module, argv: list) -> tuple[dict, list]:
    """The port script's record and its rows ``(batch, options)``, in order,
    with the timing, the state and the corpora stubbed."""
    rows_seen = []

    def time_selects(torch_, device, state, rows, **kw):
        out = {}
        for tag, kwargs in rows:
            kw2 = dict(kwargs)
            rows_seen.append((kw2.pop("batch_size", st.BATCH), kw2))
            out[tag] = {"ms_per_round": 0.25, "first_call_s": 1.5}
        return out

    def scale_datasets(skip_100k, **kw):
        yield "mirflickr25k", _fake_ds(25000)
        if not skip_100k:
            yield "corpus100k", _fake_ds(100_000)

    monkeypatch.setattr(st, "time_selects", time_selects)
    monkeypatch.setattr(st, "mid_session_state", lambda ds, device: None)
    monkeypatch.setattr(st, "scale_datasets", scale_datasets)
    out = tmp_path / "port_torch.json"
    assert module.main([*argv, "--device", "cpu", "--out", str(out)]) == 0
    return json.loads(out.read_text()), rows_seen


def _assert_keys(port: dict, ref: dict, renamed: dict = {}):
    """Every key of ``ref`` is in ``port`` (``renamed`` maps a reference key
    to the port's), recursively through the dicts both hold."""
    for k, v in ref.items():
        pk = renamed.get(k, k)
        assert pk in port, (k, sorted(port))
        if isinstance(v, dict) and isinstance(port[pk], dict):
            _assert_keys(port[pk], v, renamed)


TIMING = [
    ("pool_refine", prt, []),
    ("refine_study", rst, []),
    ("pool_sweep", pst, ["--map-out", "unused_torch.json"]),
    ("batch_size_timing", bst, []),
    ("block_sweep", bsw, []),
]


@pytest.mark.parametrize("name,module,argv", TIMING, ids=[t[0] for t in TIMING])
def test_timing_rows_and_keys_are_the_reference_s(monkeypatch, tmp_path, name, module, argv):
    want, ref_calls = _reference_timing(monkeypatch, tmp_path, name)
    got, port_calls = _port_timing(monkeypatch, tmp_path, module,
                                   [a if a.startswith("--") else str(tmp_path / a)
                                    for a in argv])
    got = got.get("timing", got)  # pool_refine and refine_study keep it in a section
    if name == "block_sweep":
        # The port's sweep adds its own blocks after the reference's.
        assert list(bsw.BLOCKS[:4]) == list(_reference("block_sweep").BLOCKS)
        port_calls = [c for c in port_calls if c[1]["block"] in bsw.BLOCKS[:4]]
        for tag in got["configs"]:
            got["configs"][tag] = {b: r for b, r in got["configs"][tag].items()
                                   if int(b) in bsw.BLOCKS[:4]}
    assert port_calls == ref_calls
    _assert_keys(got, want, {"slope_ms": "ms_per_round"})
    assert (got["device"], got["power_limit"], got["platform"]) == ("cpu", None, "cpu")


# ---------------------------------------------------------------------------
# The MAP scripts hold the reference's configurations, entries and pairs
# ---------------------------------------------------------------------------


def _curve(cfg) -> np.ndarray:
    """A stub run's MAP curve, a function of what the config asks for."""
    kw = json.dumps(sorted((k, str(v)) for k, v in cfg.method_kwargs.items()))
    base = 0.3 + 0.01 * cfg.seed + 0.001 * (sum(map(ord, kw)) % 97) + 0.1 * cfg.user.mistake_prob
    return np.round(np.linspace(base, base + 0.4, cfg.n_rounds), 4)


def _what(cfg) -> tuple:
    return (cfg.method, cfg.seed, cfg.query_batch, bool(cfg.fused_sessions), cfg.n_rounds,
            cfg.user.label_prob, cfg.user.mistake_prob, cfg.gp.length_scale, cfg.gp.noise,
            sorted((k, str(v).lower()) for k, v in cfg.method_kwargs.items()))


MAP_RUNS = [
    ("pool_refine", dict(heavy=False)),
    ("pool_refine", dict(heavy=True)),
    ("pool_sweep", {}),
    ("randomize_qmc_study", dict(heavy=False)),
    ("randomize_qmc_study", dict(heavy=True)),
]


@pytest.mark.parametrize("name,kw", MAP_RUNS, ids=[f"{n}-{k}" for n, k in MAP_RUNS])
def test_map_configs_entries_and_pairs_are_the_reference_s(monkeypatch, tmp_path, name, kw):
    import ital_tpu.runner as jrunner
    import ital_tpu_torch.runner as trunner

    seen = {"ref": [], "port": []}

    def stub(side):
        def run(cfg, dataset=None, **_):
            seen[side].append(_what(cfg))
            return {"map": _curve(cfg), "sessions": [{}] * 14,
                    "picks": np.zeros((14, cfg.n_rounds, 4), np.int64)}
        return run

    monkeypatch.setattr(jrunner, "run_experiment", stub("ref"))
    monkeypatch.setattr(trunner, "run_experiment", stub("port"))
    ref = _reference(name)
    monkeypatch.setattr(ref, "REPO", str(tmp_path))  # its record goes to tmp_path/results
    (tmp_path / "results").mkdir()
    (tmp_path / "configs").symlink_to(ROOT / "configs")
    seeds = [0, 1, 2]
    port_mod = {"pool_refine": prt, "pool_sweep": pst, "randomize_qmc_study": rqt}[name]
    if name == "pool_sweep":
        ref.run_map(seeds)
        want = json.loads((tmp_path / "results" / "pool_tradeoff.json").read_text())
    else:
        want = ref.run_map(seeds, **kw)
    got = port_mod.run_map(seeds, device=torch.device("cpu"), data=None, card=CPU,
                           log=lambda s: None, **kw)
    assert seen["port"] == seen["ref"] and len(seen["ref"]) == len(seeds) * (len(want) - (
        "paired" in want))
    assert set(got) == set(want)
    for tag, entry in want.items():
        for key, value in entry.items():
            if key != "wall_s_per_seed":
                assert got[tag][key] == value, (tag, key)
    for tag in set(got) - {"paired"}:
        by_seed = got[tag]["map_by_seed"]
        assert list(by_seed) == [str(s) for s in seeds]
        assert [c[-1] for c in by_seed.values()] == got[tag]["final_map_by_seed"]
        assert (got[tag]["device"], got[tag]["platform"]) == ("cpu", "cpu")


def test_map_half_on_jax_draws_is_the_reference_curve(monkeypatch, tmp_path):
    """``pool_refine_torch``'s MAP half fed the reference's user draws from a
    file equals ``scripts/pool_refine.py``'s on the MIRFLICKR surrogate's
    generator cut to 1500 x 128 (one topic, five rounds, standard noise):
    both configurations, to the record's four decimals."""
    import ital_tpu.runner as jrunner
    import ital_tpu_torch.runner as trunner

    draws = tmp_path / "draws_torch.npz"
    np.savez(draws, **jref.export(MIRFLICKR, [0], CUT))
    jds, tds = _cut("ital_tpu"), _cut("ital_tpu_torch")
    oj, ot = jrunner.run_experiment, trunner.run_experiment
    cut = dict(max_classes=1, n_rounds=5)
    monkeypatch.setattr(jrunner, "run_experiment",
                        lambda cfg, dataset=None: oj(dataclasses.replace(cfg, **cut), jds))
    monkeypatch.setattr(trunner, "run_experiment", lambda cfg, dataset=None, **k: ot(
        dataclasses.replace(cfg, **cut), tds, **k))
    want = _reference("pool_refine").run_map([0])
    got = prt.run_map([0], heavy=False, device=torch.device("cpu"), data=tds, card=CPU,
                      draws_path=str(draws), log=lambda s: None)
    for tag, *_ in prt.MAP_CONFIGS:
        assert got[tag]["map"] == want[tag]["map"], tag
        assert got[tag]["final_map_by_seed"] == want[tag]["final_map_by_seed"], tag
    assert got["paired"] == want["paired"]


# ---------------------------------------------------------------------------
# The reference's user draws
# ---------------------------------------------------------------------------


def test_draws_file_holds_jax_round_draws_for_the_reference_sessions():
    from ital_tpu.data import datasets
    from ital_tpu.runner import _session_plan
    from ital_tpu.utils.config import load_config
    from tests.test_torch_runner import jax_round_draws

    table = st.load_user_draws(str(DRAWS))
    ds = datasets.mirflickr()
    want = [(s, rep, c, q) for s in range(8) for rep, c, q, _ in _session_plan(
        load_config(MIRFLICKR, (f"EXPERIMENT.seed={s}",)), ds)]
    assert sorted(table) == sorted(want) and len(want) == 8 * 14
    rng = np.random.default_rng(0)
    for i in rng.choice(len(want), 6, replace=False):
        key = want[i]
        for rnd in (0, int(rng.integers(1, 10))):
            _, lab, flip = jax_round_draws(*key, rnd, 4, "cpu")
            np.testing.assert_array_equal(table[key][0][rnd], lab.numpy())
            np.testing.assert_array_equal(table[key][1][rnd], flip.numpy())


def test_fed_draws_are_the_seam_s_jax_draws(monkeypatch, tmp_path):
    """``--user-draws`` gives a run what ``jax_round_draws`` at the runner's
    seam gives it: a noisy toy run of uncertainty sampling, both ways."""
    import ital_tpu_torch.runner as trunner
    from tests.test_torch_runner import jax_round_draws

    toy = str(ROOT / "configs" / "toy.ini")
    draws = tmp_path / "toy_torch.npz"
    np.savez(draws, **jref.export(toy, [0]))
    out = tmp_path / "toy_methods_torch.json"
    argv = ["--dataset", "toy", "--methods", "uncertainty_sampling", "--seeds", "0",
            "--query-batch", "2", "--device", "cpu"]
    own = trunner.round_draws
    assert mct.main([*argv, "--user-draws", str(draws), "--out", str(out)]) == 0
    assert trunner.round_draws is own  # the block put the seam back
    got = json.loads(out.read_text())["uncertainty_sampling"]
    monkeypatch.setattr(trunner, "round_draws", jax_round_draws)
    want, _ = mct.run_one("uncertainty_sampling", 0.8, 0.05, 0, None, dataset="toy",
                          query_batch=2, device="cpu")
    assert got["map"] == [round(float(v), 4) for v in want["map"]]
    assert got["user_draws"] == draws.name


@pytest.mark.parametrize("script", ["method_comparison_torch", "pool_refine_torch"])
def test_user_draws_refuses_a_file_that_lacks_a_session(tmp_path, script):
    with np.load(DRAWS) as f:
        arrays = {k: f[k] for k in f.files}
    keep = np.ones(len(arrays["sessions"]), bool)
    keep[17] = False  # seed 1's fourth topic
    short = tmp_path / "short_torch.npz"
    np.savez(short, **{k: v[keep] for k, v in arrays.items()})
    out = tmp_path / "out_torch.json"
    argv = {"method_comparison_torch": ["--methods", "random", "--seeds", "0-2"],
            "pool_refine_torch": ["--skip-timing", "--map", "--seeds", "0-2"]}[script]
    module = {"method_comparison_torch": mct, "pool_refine_torch": prt}[script]
    with pytest.raises(SystemExit) as e:
        module.main([*argv, "--device", "cpu", "--user-draws", str(short), "--out", str(out)])
    seed, rep, cls, query = arrays["sessions"][17]
    assert f"no draws for session seed={seed} rep={rep} cls={cls} query={query}" in str(
        e.value.code)
    assert not out.exists()


# ---------------------------------------------------------------------------
# Every script needs a card unless told --device cpu
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("script", ["pool_refine_torch", "refine_study_torch",
                                    "pool_sweep_torch", "randomize_qmc_study_torch",
                                    "batch_size_timing_torch", "block_sweep_torch"])
def test_each_study_needs_a_card_unless_told_cpu(tmp_path, script):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, str(SCRIPTS / f"{script}.py"), "--out",
                           str(tmp_path / "out_torch.json")],
                          capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    assert not any(tmp_path.glob("**/*.json"))


# ---------------------------------------------------------------------------
# The full-scan parting at 25 000 x 512
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("session", [0, 1, 7])
def test_first_greedy_picks_differ_only_within_f32_rounding_at_full_size(session):
    """``pool_refine_map_cpu.json``'s ``full 128`` at seed 0 on the full
    25 000 x 512 surrogate: after the query, the first greedy step's MI
    saturates at about 0.3957 for the candidates far from it.  Each
    package's pick lies within 1e-6 of the other's maximum, the tie set
    within 1e-6 holds more than one row in both, and evaluated in f64 both
    picks lie within 2e-7 of the f64 maximum: below f32 resolution at this
    MI, neither order is the exact one."""
    import jax.numpy as jnp

    from ital_tpu.data import datasets as jdatasets
    from ital_tpu.models import gp as jgp
    from ital_tpu.runner import _session_plan
    from ital_tpu.select import ital as jital
    from ital_tpu.select.base import StrategyParams as JParams
    from ital_tpu.utils.config import load_config
    from ital_tpu_torch.models import gp as tgp
    from ital_tpu_torch.select import ital as tital
    from ital_tpu_torch.select.base import StrategyParams as TParams

    ds = jdatasets.mirflickr()
    cfg = load_config(MIRFLICKR, ("EXPERIMENT.seed=0",))
    q = _session_plan(cfg, ds)[session][2]
    jp = JParams(label_prob=jnp.asarray(0.8), mistake_prob=jnp.asarray(0.05))
    js = jgp.gp_set_query(jgp.gp_init(jnp.asarray(ds.x), 50.0, 1.0, 0.1, cfg.cap),
                          jnp.asarray(q))
    jmi = np.array(jital.score_candidates_mi(js, jnp.zeros(4, jnp.int32), 0, jp))
    mis = {}
    for dt in (torch.float32, torch.float64):
        x = torch.from_numpy(ds.x).to(dt)
        ts = tgp.gp_set_query(tgp.gp_init(x, 50.0, 1.0, 0.1, cfg.cap), q)
        tp = TParams(**{k: torch.tensor(v, dtype=dt) for k, v in (
            ("label_prob", 0.8), ("mistake_prob", 0.05), ("jitter", 1e-6), ("tradeoff", 0.5))})
        mis[dt] = tital.score_candidates_mi(ts, torch.zeros(4, dtype=torch.long), 0,
                                            tp).numpy().copy()
    tmi, mi64 = mis[torch.float32], mis[torch.float64]
    for v in (jmi, tmi, mi64):
        v[q] = -np.inf
    j, t = int(np.argmax(jmi)), int(np.argmax(tmi))
    assert jmi.max() == pytest.approx(0.3957055, abs=1e-6)
    assert jmi.max() - jmi[t] <= 1e-6 and tmi.max() - tmi[j] <= 1e-6
    assert (jmi >= jmi.max() - 1e-6).sum() > 1 and (tmi >= tmi.max() - 1e-6).sum() > 1
    assert mi64.max() - mi64[j] <= 2e-7 and mi64.max() - mi64[t] <= 2e-7
    scored = np.isfinite(jmi)
    assert np.max(np.abs(jmi[scored] - tmi[scored])) <= 5e-6


# ---------------------------------------------------------------------------
# The rows chip_smoke.py times, and a row out of memory
# ---------------------------------------------------------------------------


def _smoke_rows() -> dict:
    """``chip_smoke._study_rows`` at 25 000 rows, by script name."""
    import chip_smoke

    return {tag.split(": ")[0]: kw for tag, kw in chip_smoke._study_rows(25_000)}


@pytest.mark.parametrize("name,module,argv", TIMING, ids=[t[0] for t in TIMING])
def test_chip_smoke_times_a_row_the_script_times(monkeypatch, tmp_path, name, module, argv):
    """The row each script names as its ``SMOKE_ROW`` is one the script
    itself times at 25 000 rows, with the same options."""
    _, calls = _port_timing(monkeypatch, tmp_path, module,
                            [a if a.startswith("--") else str(tmp_path / a) for a in argv])
    kw = dict(_smoke_rows()[name])
    assert (kw.pop("batch_size", st.BATCH), kw) in calls


def test_chip_smoke_times_randomize_qmc_study_s_randomized_configuration():
    from ital_tpu_torch.utils.config import load_config

    flag = dict(rqt.CONFIGS)[rqt.SMOKE_ROW]
    cfg = load_config(MIRFLICKR, tuple(f"METHOD.{kv}" for kv in
                                       rqt.PRODUCTION + (f"randomize_qmc={flag}",)))
    assert _smoke_rows()["randomize_qmc_study"] == cfg.method_kwargs


@pytest.mark.parametrize("where", ["warm-up", "capture"])
def test_a_row_out_of_memory_records_its_error_and_is_not_timed_again(monkeypatch, tmp_path,
                                                                      where):
    """A full-scan row at m = 8 that runs out of device memory, in its eager
    warm-up or in its capture, is recorded as its error; every row is timed
    once and the other rows keep their times."""
    from ital_tpu_torch import graphs

    calls = []

    def time_selects(torch_, device, state, rows, **kw):
        (tag, kwargs), = rows
        calls.append((tag, kwargs["batch_size"]))
        if kwargs["batch_size"] == 8 and not kwargs["pool_size"]:
            oom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 40.00 GiB")
            if where == "warm-up":
                raise oom
            raise graphs.CaptureError("select_ital could not be captured") from oom
        return {tag: {"ms_per_round": 1.0}}

    monkeypatch.setattr(st, "time_selects", time_selects)
    monkeypatch.setattr(st, "mid_session_state", lambda ds, device: None)
    monkeypatch.setattr(st, "scale_datasets",
                        lambda skip_100k, **kw: iter([("mirflickr25k", _fake_ds(25000))]))
    out = tmp_path / "bst_torch.json"
    assert bst.main(["--device", "cpu", "--batch-sizes", "6,8", "--out", str(out)]) == 0
    rows = json.loads(out.read_text())["rows"]
    assert sorted(calls) == sorted((tag, m) for m in (6, 8) for tag, *_ in bst.CONFIGS)
    from ital_tpu_torch.select.ital import mi_block

    first = "CUDA out of memory" if where == "warm-up" else "select_ital could not"
    for tag, n_qmc in (("full 128", 128), ("full 256", 256)):
        assert rows["m8"][tag]["error"].startswith(
            f"out of memory at block {mi_block(8, n_qmc)}: " + first)
        assert set(rows["m8"][tag]) == {"error"}
        assert rows["m6"][tag] == {"ms_per_round": 1.0}
    assert rows["m8"]["pool4096 32+top64@512"] == {"ms_per_round": 1.0}


# ---------------------------------------------------------------------------
# The tie-order study: the corpus's rows in another order
# ---------------------------------------------------------------------------


def test_a_row_order_moves_each_session_s_query_and_draws_with_its_row(tmp_path):
    import tie_order_study_torch as tos
    from ital_tpu_torch.runner import _session_plan
    from ital_tpu_torch.utils.config import load_config

    ds = _cut("ital_tpu_torch")
    assert (tos.row_order(ds.n, 0) == np.arange(ds.n)).all()
    perm = tos.row_order(ds.n, 3)
    assert sorted(perm) == list(range(ds.n)) and (perm != np.arange(ds.n)).any()
    moved = tos.permuted(ds, perm)
    np.testing.assert_array_equal(moved.x, ds.x[perm])
    np.testing.assert_array_equal(moved.relevance, ds.relevance[perm])
    for seed in (0, 5):
        cfg = load_config(MIRFLICKR, (f"EXPERIMENT.seed={seed}",))
        plan, moved_plan = _session_plan(cfg, ds), _session_plan(cfg, moved)
        assert [(r, c, int(perm[q])) for r, c, q in moved_plan] == plan
    perm = tos.row_order(25_000, 3)  # the draws file's sessions are the surrogate's
    table = st.load_user_draws(str(DRAWS))
    full = st.load_user_draws(tos.moved_draws(str(DRAWS), perm, str(tmp_path / "d_torch.npz")))
    inv = np.argsort(perm)
    for (seed, rep, c, q), (lab, flip) in table.items():
        got = full[(seed, rep, c, int(inv[q]))]
        np.testing.assert_array_equal(got[0], lab)
        np.testing.assert_array_equal(got[1], flip)


@pytest.mark.parametrize("order", [1, 3])
def test_a_row_order_leaves_every_row_s_mi_as_it_was(order):
    """The study's premise: with the rows in another order, each row's MI at
    the query is the same f32 value, bit for bit, so only which row comes
    first in a tie can differ."""
    import tie_order_study_torch as tos
    from ital_tpu_torch.models import gp as tgp
    from ital_tpu_torch.select.base import StrategyParams
    from ital_tpu_torch.select.ital import score_candidates_mi
    from ital_tpu_torch.utils.config import load_config

    cfg = load_config(MIRFLICKR)
    ds = _cut("ital_tpu_torch")
    perm = tos.row_order(ds.n, order)
    inv = np.argsort(perm)
    params = StrategyParams.create("cpu", label_prob=0.8, mistake_prob=0.05)
    mi = []
    for data, q in ((ds, 17), (tos.permuted(ds, perm), int(inv[17]))):
        s = tgp.gp_set_query(tgp.gp_init(torch.from_numpy(data.x), cfg.gp.length_scale,
                                         cfg.gp.var, cfg.gp.noise, cfg.cap), q)
        mi.append(score_candidates_mi(s, torch.zeros(4, dtype=torch.long), 0, params))
    assert torch.equal(mi[1][torch.from_numpy(inv)], mi[0])


def test_tie_order_record_pairs_each_order_with_the_references(monkeypatch, tmp_path):
    """Each order's entry holds the MAP entry, the first picks as rows of
    the corpus's own order and its paired intervals against the CPU and TPU
    records' ``full 128`` at the same seeds; ``over_orders`` pairs the mean
    over orders at each seed."""
    import compare_records_torch as crt
    import tie_order_study_torch as tos

    seen = []
    finals = {0: {0: 0.80, 3: 0.83}, 2: {0: 0.86, 3: 0.85}}

    def map_runs(configs, seeds, *, data, draws_path, picks, **kw):
        (tag, overrides), = configs
        assert overrides == prt.method_overrides(*prt.MAP_CONFIGS[0][1:])
        table = st.load_user_draws(draws_path)
        seen.append((data, table))
        picks[tag] = {str(s): np.full((14, 10, 4), 5 + s).tolist() for s in seeds}
        order = 0 if len(seen) == 1 else 2
        return {tag: {"final_map_by_seed": [finals[order][s] for s in seeds], "seeds": seeds}}

    monkeypatch.setattr(st, "map_runs", map_runs)
    out = tmp_path / "tie_torch.json"
    assert tos.main(["--device", "cpu", "--orders", "0,2", "--seeds", "0,3",
                     "--user-draws", str(DRAWS), "--out", str(out)]) == 0
    record = json.loads(out.read_text())
    refs = {}
    for name, file in (("cpu", "pool_refine_map_cpu.json"), ("tpu", "pool_refine.json")):
        entry = json.loads((ROOT / "results" / file).read_text())["map"]["full 128"]
        refs[name] = dict(zip(entry["seeds"], entry["final_map_by_seed"]))

    def check(got, by_seed, ref):
        want = crt.interval([by_seed[s] - ref[s] for s in (0, 3)])
        assert got["mean"] == pytest.approx(want["mean"]) and got["seeds"] == [0, 3]
        assert (got["lo"], got["hi"]) == pytest.approx((want["lo"], want["hi"]))
        assert got["held"] == (want["lo"] <= 0 <= want["hi"])
        return got["held"]

    assert list(record["orders"]) == ["0", "2"]
    held = {"cpu": 0, "tpu": 0}
    for order, entry in record["orders"].items():
        perm = tos.row_order(25_000, int(order))
        assert entry["first_picks_by_seed"] == {str(s): [int(perm[5 + s])] * 14 for s in (0, 3)}
        for name, ref in refs.items():
            held[name] += check(entry["paired_with"][name], finals[int(order)], ref)
    over = record["over_orders"]
    mean = {s: (finals[0][s] + finals[2][s]) / 2 for s in (0, 3)}
    assert over["final_map_by_seed"] == pytest.approx([mean[0], mean[3]])
    assert over["final_mean_by_order"] == pytest.approx({"0": 0.815, "2": 0.855})
    for name, ref in refs.items():
        check(over["paired_with"][name], mean, ref)
    assert over["orders_held"] == held
    assert seen[0][1].keys() == st.load_user_draws(str(DRAWS)).keys()
    inv = np.argsort(tos.row_order(25_000, 2))
    assert sorted(seen[1][1]) == sorted((s, r, c, int(inv[q])) for s, r, c, q in seen[0][1])
    np.testing.assert_array_equal(seen[1][0].x[inv], seen[0][0].x)


def test_f32_phi_is_the_reference_s_erfc_up_to_rounding():
    """``--phi f32``'s normal CDF is the reference's ``ops.mvn.norm_cdf``
    (an f32 erfc) to one f32 step at 1, over [-6, 6], clamped alike."""
    import jax.numpy as jnp

    import tie_order_study_torch as tos
    from ital_tpu.ops import mvn as jmvn

    x = np.linspace(-6.0, 6.0, 20001, dtype=np.float32)
    got = tos.f32_norm_cdf(torch.from_numpy(x)).numpy()
    want = np.asarray(jmvn.norm_cdf(jnp.asarray(x)))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=6e-8)
    assert got.min() == np.float32(1e-6) and got.max() == np.float32(1 - 1e-6)


@pytest.mark.parametrize("kind", ["f64", "f32"])
def test_phi_sets_the_chain_s_cdf_inside_the_block_only(kind):
    import tie_order_study_torch as tos
    from ital_tpu_torch.ops import mvn

    own = mvn.norm_cdf
    x = torch.linspace(-3, 3, 101)
    with tos.phi(kind):
        assert mvn.norm_cdf is {"f64": own, "f32": tos.f32_norm_cdf}[kind]
        got = mvn.norm_cdf(x)
    assert mvn.norm_cdf is own
    assert torch.equal(got, own(x) if kind == "f64" else tos.f32_norm_cdf(x))
    assert kind == "f64" or not torch.equal(got, own(x))  # the f64 detour rounds otherwise


def test_reference_orders_keep_each_session_and_pair_with_the_port(tmp_path):
    """``jax_reference.py orders`` runs the reference with the corpus's rows
    reordered, each session on its own query row and key: at the 1500 x 128
    cut (no MI ties) order 2's curve is order 0's, order 0's is
    ``reference_run``'s own, and the pairing with a port record averages
    each side over its orders."""
    from ital_tpu.data import datasets
    from ital_tpu.utils.config import load_config

    cut = (*CUT, "EXPERIMENT.max_classes=1", "EXPERIMENT.n_rounds=2")
    port = {"orders": {"0": {"seeds": [0]}, "5": {"seeds": [0]}},
            "over_orders": {"final_map_by_seed": [0.5]}}
    (tmp_path / "port_torch.json").write_text(json.dumps(port))
    got = jref.orders(MIRFLICKR, [0, 2], [0], cut, port_path=str(tmp_path / "port_torch.json"),
                      log=lambda s: None)
    cfg = load_config(MIRFLICKR, cut + ("EXPERIMENT.seed=0", "EXPERIMENT.query_batch=7",
                                        "EXPERIMENT.fused_sessions=true",
                                        *(f"METHOD.{kv}" for kv in prt.method_overrides(
                                            *prt.MAP_CONFIGS[0][1:]))))
    own = jref.reference_run(cfg, datasets.load_dataset(cfg.dataset, **cfg.dataset_kwargs))
    want = [round(float(v), 4) for v in own["map"]]
    assert got["orders"]["0"]["map_by_seed"] == {"0": want}
    assert got["orders"]["2"]["map_by_seed"] == {"0": want}
    assert got["final_map_by_seed"] == [want[-1]]
    assert got["port_over_orders"]["mean"] == pytest.approx(0.5 - want[-1])
    assert got["port_over_orders"]["port_orders"] == ["0", "5"]

"""The port's study scripts (``scripts/*_torch.py``) against the reference's.

* ``method_comparison_torch.run_one`` equals ``scripts/method_comparison.py``'s
  curve on ``configs/toy.ini`` with JAX's draws fed in; its record keys and
  file stems are the reference's (plus ``device``/``power_limit`` and
  ``_torch``), and it never overwrites a reference record;
* ``compare_records_torch`` against a hand computation with ``scipy.stats.t``;
* ``run_scenarios_torch`` writes the reference's keys and curves and exits
  non-zero when a scenario fails;
* ``drift_study_torch`` labels the reference protocol's indices, its oracle
  is the reference's, and its rows carry the reference's keys;
* ``record_bigcap_session_torch`` takes the large-cap path on a gloo mesh;
* every script that runs the port exits non-zero without a card unless
  given ``--device cpu``;
* ``ital_regression``'s conditional-variance solve goes through
  ``ops/chol.py::tri_solve`` on both its paths, bit-equal on the CPU to the
  direct left-side solve it replaced.
"""

import importlib.util
import io
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts"
sys.path.insert(0, str(SCRIPTS))

import compare_records_torch as crt  # noqa: E402
import drift_study_torch as dst  # noqa: E402
import method_comparison_torch as mct  # noqa: E402
import run_scenarios_torch as rst  # noqa: E402

PRODUCTION = "pool_size=4096,n_qmc=32,refine_top=64,refine_n_qmc=512"


def _reference(name: str):
    """A reference script under ``scripts/`` as a module (never run as main)."""
    spec = importlib.util.spec_from_file_location(f"ref_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# method_comparison_torch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["uncertainty_sampling", "borderline_sampling"])
def test_run_one_equals_the_reference_curve_on_jax_draws(monkeypatch, method):
    """configs/toy.ini at seed 0, a noisy user, cohorts of 2, fused: the
    port fed JAX's draws gives the reference's MAP curve."""
    from ital_tpu_torch import runner as trunner
    from tests.test_torch_runner import jax_round_draws

    ref = _reference("method_comparison")
    want, _ = ref.run_one(method, 0.8, 0.05, 0, None, dataset="toy", query_batch=2)
    monkeypatch.setattr(trunner, "round_draws", jax_round_draws)
    got, _ = mct.run_one(method, 0.8, 0.05, 0, None, dataset="toy", query_batch=2,
                         device="cpu")
    assert len(got["sessions"]) == len(want["sessions"]) == 8
    np.testing.assert_allclose(got["map"], np.asarray(want["map"]), atol=1e-6)


def _replay_in_jax(got: dict, ds, cfg, seed: int = 0) -> list:
    """Replay a port run's picks in ``ital_tpu`` with JAX's user draws: per
    session, None where every pick is JAX's greedy pick on the port's state,
    else ``(round, step, MI of JAX's pick - MI of the port's)`` at the
    first parting (the session is not followed past it)."""
    import jax
    import jax.numpy as jnp

    from ital_tpu.data.user import simulate_feedback
    from ital_tpu.models import gp as jgp
    from ital_tpu.select import ital as jital
    from ital_tpu.select.base import StrategyParams

    params = StrategyParams(label_prob=jnp.asarray(cfg.user.label_prob),
                            mistake_prob=jnp.asarray(cfg.user.mistake_prob))
    partings = []
    for k, s in enumerate(got["sessions"]):
        rep, c, q = s["rep"], s["cls"], s["query"]
        st = jgp.gp_set_query(jgp.gp_init(jnp.asarray(ds.x), cfg.gp.length_scale, cfg.gp.var,
                                          cfg.gp.noise, cfg.cap), jnp.asarray(q))
        skey = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(seed), rep), c), q)
        relevant = jnp.asarray(ds.relevance[:, c])
        parting = None
        for rnd in range(cfg.n_rounds):
            picks = got["picks"][k, rnd]
            for t in range(len(picks)):
                mi = np.array(jital.score_candidates_mi(st, jnp.asarray(picks), t, params))
                mi[np.asarray(st.idx)[np.asarray(st.active)]] = -np.inf
                mi[picks[:t]] = -np.inf
                own = int(np.argmax(mi))
                if own != picks[t]:
                    parting = (rnd, t, float(mi[own] - mi[picks[t]]))
                    break
            if parting:
                break
            _, k_user = jax.random.split(jax.random.fold_in(skey, rnd))
            yb, valid = simulate_feedback(k_user, jnp.asarray(picks), relevant,
                                          params.label_prob, params.mistake_prob)
            st = jgp.gp_update(st, jnp.asarray(picks), yb, valid)
        partings.append(parting)
    return partings


def test_run_one_ital_picks_the_reference_picks_up_to_mi_ties(monkeypatch):
    """ITAL on the same run: on the 2-D toy most candidates share the
    saturated MI to the last ulp, so the two packages' curves part at f32
    ties.  Replayed in ``ital_tpu`` on the port's own picks and JAX's user
    draws, each of the port's picks is JAX's greedy pick, or its MI lies
    within 1e-5 of that pick's (a tie), where the session parts."""
    from ital_tpu_torch import runner as trunner
    from ital_tpu_torch.data.datasets import load_dataset
    from ital_tpu_torch.utils.config import load_config
    from tests.test_torch_runner import jax_round_draws

    monkeypatch.setattr(trunner, "round_draws", jax_round_draws)
    got, _ = mct.run_one("ital", 0.8, 0.05, 0, None, dataset="toy", query_batch=2,
                         device="cpu")
    cfg = load_config(str(ROOT / "configs" / "toy.ini"),
                      ("GP.cap=16", "USER.label_prob=0.8", "USER.mistake_prob=0.05"))
    partings = _replay_in_jax(got, load_dataset(cfg.dataset, **cfg.dataset_kwargs), cfg)
    assert all(p is None or p[2] <= 1e-5 for p in partings), partings
    assert partings.count(None) >= 6  # 7 of the 8 sessions hold to the end here


def test_full_scan_ital_on_the_surrogate_parts_from_the_reference_at_mi_ties(monkeypatch):
    """``mirflickr_methods.json``'s default ITAL (a full scan at n_qmc 128)
    on the MIRFLICKR surrogate's generator cut to 2000 rows, 4 sessions in
    fused cohorts of 2, JAX's draws fed in: the port parts from JAX's greedy
    picks only where the saturated MI of uninformed candidates (about
    0.3957 at label_prob 0.8, mistake_prob 0.05) ties within f32 rounding."""
    from ital_tpu_torch import runner as trunner
    from ital_tpu_torch.data.datasets import load_dataset
    from ital_tpu_torch.utils.config import load_config
    from tests.test_torch_runner import jax_round_draws

    monkeypatch.setattr(trunner, "round_draws", jax_round_draws)
    cfg = load_config(str(ROOT / "configs" / "mirflickr.ini"), (
        "EXPERIMENT.dataset=corpus100k", "DATA.n=2000", "DATA.dim=512", "DATA.n_classes=14",
        "EXPERIMENT.max_classes=4", "EXPERIMENT.query_batch=2", "EXPERIMENT.fused_sessions=true"))
    ds = load_dataset(cfg.dataset, **cfg.dataset_kwargs)
    got = trunner.run_experiment(cfg, ds, device="cpu")
    partings = _replay_in_jax(got, ds, cfg)
    parted = [p for p in partings if p is not None]
    assert parted and all(p[2] <= 1e-6 for p in parted), partings


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_heavy_noise_digits_on_jax_draws_is_the_reference_record(monkeypatch, seed):
    """``results/digits_methods_heavynoise.json`` (a CPU run of the
    reference): with JAX's user draws fed in, the port's uncertainty
    sampling gives the recorded curve of each seed to its 4 decimals, so a
    paired delta of the port's own record against it is the user draws'."""
    from ital_tpu_torch import runner as trunner
    from tests.test_torch_runner import jax_round_draws

    want = json.loads((ROOT / "results" / "digits_methods_heavynoise.json").read_text())
    monkeypatch.setattr(trunner, "round_draws", jax_round_draws)
    got, _ = mct.run_one("uncertainty_sampling", 0.6, 0.15, seed, None, dataset="digits",
                         query_batch=5, device="cpu")
    assert [round(float(v), 4) for v in got["map"]] == \
        want["uncertainty_sampling"]["map_by_seed"][str(seed)]


def _reference_record(monkeypatch, argv: list) -> tuple[str, dict]:
    """The reference main's output path and record for ``argv``, its runs
    stubbed and its file writes caught (nothing touches ``results/``)."""
    ref = _reference("method_comparison")
    written = {}

    class _Sink(io.StringIO):
        def close(self):
            written["text"] = self.getvalue()
            super().close()

    def fake_open(path, mode="r", *a, **kw):
        assert "w" in mode
        written["path"] = path
        return _Sink()

    monkeypatch.setattr(ref, "open", fake_open, raising=False)
    monkeypatch.setattr(ref, "run_one", lambda *a, **kw: (
        {"map": np.linspace(0.1, 0.5, 3), "sessions": [{}] * 4}, 0.0))
    monkeypatch.setattr(sys, "argv", ["method_comparison.py", *argv])
    assert ref.main() == 0
    return written["path"], json.loads(written["text"])


STEM_FLAGS = [
    [],
    ["--heavy"],
    ["--gp-noise", "0.5"],
    ["--heavy", "--gp-noise", "1", "--learn-every", "2"],
    ["--ital-kwargs", PRODUCTION],
    ["--ital-kwargs", "n_qmc=32,refine_top=64,refine_n_qmc=512"],
    ["--gp-overrides", "learn_prior_strength=1.0,learn_noise_floor=0.05"],
    ["--gp-overrides", "corpus_dtype=bfloat16", "--ital-kwargs", PRODUCTION],
    ["--dataset", "digits", "--heavy", "--tag", "cpu"],
]


@pytest.mark.parametrize("flags", STEM_FLAGS, ids=lambda f: " ".join(f) or "default")
def test_stem_is_the_reference_stem_plus_torch(monkeypatch, flags):
    path, _ = _reference_record(monkeypatch, flags)
    want = os.path.basename(path)[:-len(".json")]
    assert mct.record_stem(mct.parser().parse_args(flags)) == want + "_torch"


def test_record_keys_hold_the_reference_keys_and_the_card(monkeypatch, tmp_path):
    _, want = _reference_record(monkeypatch, ["--methods", "uncertainty_sampling",
                                              "--seeds", "0"])
    out = tmp_path / "toy_methods_torch.json"
    assert mct.main(["--dataset", "toy", "--methods", "uncertainty_sampling", "--seeds", "0",
                     "--query-batch", "2", "--device", "cpu", "--out", str(out)]) == 0
    got = json.loads(out.read_text())["uncertainty_sampling"]
    assert set(got) == set(want["uncertainty_sampling"]) | {"device", "power_limit"}
    assert (got["device"], got["power_limit"], got["platform"]) == ("cpu", None, "cpu")
    assert got["seeds"] == [0] and got["sessions"] == 8 and len(got["map"]) == 10


def test_refuses_to_overwrite_a_reference_record():
    record = ROOT / "results" / "mirflickr_methods.json"
    before = record.read_bytes()
    with pytest.raises(SystemExit) as e:
        mct.main(["--dataset", "toy", "--seeds", "0", "--device", "cpu",
                  "--out", str(record)])
    assert e.value.code not in (0, None)
    assert record.read_bytes() == before


def test_seeds_take_lists_and_ranges():
    import study_torch

    assert study_torch.parse_seeds("0-3,7, 9-10") == [0, 1, 2, 3, 7, 9, 10]
    assert study_torch.parse_seeds("0,1,2") == [0, 1, 2]


@pytest.mark.parametrize("script,argv", [
    ("method_comparison_torch", ["--dataset", "toy", "--seeds", "0"]),
    ("run_scenarios_torch", ["--quick", "--seeds", "0", "--only", "config1"]),
    ("drift_study_torch", ["--n", "500", "--rounds", "2", "--every", "1"]),
    ("record_bigcap_session_torch", []),
])
def test_each_script_needs_a_card_unless_told_cpu(tmp_path, script, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, str(SCRIPTS / f"{script}.py"), *argv, "--out",
                           str(tmp_path / "out_torch.json")],
                          capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    assert not any(tmp_path.glob("**/*.json"))


def test_no_script_imports_jax_or_the_reference():
    import re

    for path in SCRIPTS.glob("*_torch.py"):
        text = path.read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|ital_tpu)\b", text, re.M), path


# ---------------------------------------------------------------------------
# compare_records_torch
# ---------------------------------------------------------------------------


def _method_record(curves_by_method: dict) -> dict:
    return {m: {"map_by_seed": {str(s): c for s, c in cs.items()},
                "final_map_by_seed": [c[-1] for c in cs.values()], "seeds": list(cs)}
            for m, cs in curves_by_method.items()}


def _hand(deltas):
    from scipy import stats

    d = np.asarray(deltas, np.float64)
    half = stats.t.ppf(0.975, d.size - 1) * d.std(ddof=1) / math.sqrt(d.size)
    return d.mean(), d.mean() - half, d.mean() + half


def test_compare_matches_a_hand_computation():
    rng = np.random.default_rng(3)
    ref_c = {m: {s: list(rng.uniform(0.3, 0.9, 4)) for s in range(6)} for m in ("a", "b")}
    shift = {"a": [0.05, 0.02, 0.11, 0.04, 0.07, 0.03], "b": [0.0] * 5 + [0.3]}
    port_c = {m: {s: [v + shift[m][s] for v in c] for s, c in cs.items() if s < 5 or m == "b"}
              for m, cs in ref_c.items()}
    port_c["a"][9] = [0.5] * 4  # a seed the reference lacks: not paired
    out = crt.compare(_method_record(port_c), _method_record(ref_c))
    a = out["pairs"]["a"]
    assert a["seeds"] == [0, 1, 2, 3, 4] and a["final"]["n"] == 5
    mean, lo, hi = _hand(shift["a"][:5])
    assert math.isclose(a["final"]["mean"], mean, abs_tol=1e-12)
    assert math.isclose(a["final"]["lo"], lo, abs_tol=1e-12)
    assert math.isclose(a["final"]["hi"], hi, abs_tol=1e-12)
    assert math.isclose(a["mean_map"]["mean"], mean, abs_tol=1e-12)  # every round shifted
    assert a["held"] is False and a["first_parting_round"] == 0
    b = out["pairs"]["b"]
    mean, lo, hi = _hand(shift["b"])
    assert (b["final"]["n"], b["held"]) == (6, lo <= 0 <= hi)
    assert math.isclose(b["final"]["hi"], hi, abs_tol=1e-12)
    ref_order = sorted("ab", key=lambda m: -np.mean([ref_c[m][s][-1] for s in b["seeds"]
                                                     if s in port_c[m]]))
    assert out["ordering"]["reference"] == ref_order


def test_compare_pairs_one_entry_under_a_key(tmp_path):
    """A refine-study entry (finals only) against the port's one method."""
    ref = {"map": {"32+top64@512": {"final_map_by_seed": [0.9, 0.8, 0.85], "seeds": [0, 1, 2],
                                    "map": [0.5, 0.9]}}}
    port = _method_record({"ital": {0: [0.4, 0.91], 1: [0.5, 0.79], 2: [0.6, 0.86]}})
    (tmp_path / "p.json").write_text(json.dumps(port))
    (tmp_path / "r.json").write_text(json.dumps(ref))
    assert crt.main([str(tmp_path / "p.json"), str(tmp_path / "r.json"), "--ref-key",
                     "map/32+top64@512", "--json", str(tmp_path / "o.json")]) == 0
    out = json.loads((tmp_path / "o.json").read_text())
    p = out["pairs"]["ital"]
    mean, lo, hi = _hand([0.01, -0.01, 0.01])
    assert math.isclose(p["final"]["mean"], mean, abs_tol=1e-12)
    assert math.isclose(p["final"]["lo"], lo, abs_tol=1e-12)
    assert p["mean_map"] is None and p["held"] is True and out["ordering"] == {}


def test_compare_reads_a_scenario_record():
    rec = {"method": "ital", "map_by_seed": {"0": [0.1, 0.2], "1": [0.3, 0.4]}}
    other = {"method": "ital", "map_by_seed": {"0": [0.1, 0.25], "1": [0.3, 0.35]}}
    p = crt.compare(rec, other)["pairs"]["ital"]
    assert p["final"]["n"] == 2 and math.isclose(p["final"]["mean"], 0.0, abs_tol=1e-12)
    assert p["held"] is True


# ---------------------------------------------------------------------------
# run_scenarios_torch
# ---------------------------------------------------------------------------


def test_scenarios_write_the_reference_keys_and_curves(monkeypatch, tmp_path):
    """config1's record keys are the reference's; with uncertainty sampling
    (no MI ties) its noiseless curve is the reference's too."""
    ref = _reference("run_scenarios")
    extra = ("config1_toy_b1_uncertainty", "configs/toy.ini",
             ("EXPERIMENT.method=uncertainty_sampling",))
    for mod in (ref, rst):
        monkeypatch.setattr(mod, "SCENARIOS", [mod.SCENARIOS[0], extra])
    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(sys, "argv", ["run_scenarios.py", "--quick", "--seeds", "0",
                                      "--only", "config1", "--out", str(tmp_path / "ref")])
    assert ref.main() == 0
    assert rst.main(["--quick", "--seeds", "0", "--only", "config1", "--device", "cpu",
                     "--out", str(tmp_path / "port")]) == 0
    want = json.loads((tmp_path / "ref" / "config1_toy_b1.json").read_text())
    got = json.loads((tmp_path / "port" / "config1_toy_b1_torch.json").read_text())
    assert set(got) == set(want) | {"device", "power_limit"}
    assert got["seeds"] == [0] and got["quick"] is True and len(got["map"]) == 3
    # A noiseless user on the toy: the draws decide nothing.
    want = json.loads((tmp_path / "ref" / "config1_toy_b1_uncertainty.json").read_text())
    got = json.loads((tmp_path / "port" / "config1_toy_b1_uncertainty_torch.json").read_text())
    assert got["map_by_seed"] == want["map_by_seed"]
    summary = json.loads((tmp_path / "port" / "summary_torch.json").read_text())
    assert set(summary) == {"config1_toy_b1", "config1_toy_b1_uncertainty"}


def test_a_failing_scenario_is_recorded_and_fails_the_run(monkeypatch, tmp_path):
    monkeypatch.setattr(rst, "SCENARIOS", [
        ("config1_toy_b1", "configs/toy.ini", ()),
        ("broken", "configs/toy.ini", ("EXPERIMENT.method=no_such_strategy",))])
    assert rst.main(["--quick", "--seeds", "0", "--device", "cpu",
                     "--out", str(tmp_path)]) == 1
    summary = json.loads((tmp_path / "summary_torch.json").read_text())
    assert "error" in summary["broken"] and "map" in summary["config1_toy_b1"]
    assert (tmp_path / "config1_toy_b1_torch.json").exists()
    assert not (tmp_path / "broken_torch.json").exists()


# ---------------------------------------------------------------------------
# drift_study_torch
# ---------------------------------------------------------------------------


def _jax_drift_labels(ds, rounds: int, seed: int = 0) -> list:
    """The reference script's protocol (noiseless user) at ``ds``'s size:
    its labeled indices, in order."""
    import jax
    import jax.numpy as jnp

    from ital_tpu.data.user import simulate_feedback
    from ital_tpu.models import gp as gp_mod
    from ital_tpu.select.base import StrategyParams, get_strategy

    rng = np.random.default_rng(seed)
    q = int(rng.integers(0, ds.n))
    cls = int(np.argmax(ds.relevance[q])) if ds.relevance[q].any() else 0
    relevant = jnp.asarray(ds.relevance[:, cls])
    state = gp_mod.gp_set_query(
        gp_mod.gp_init(jnp.asarray(ds.x), dst.LS, dst.VAR, dst.NOISE, dst.CAP), jnp.asarray(q))
    params = StrategyParams(label_prob=jnp.asarray(1.0), mistake_prob=jnp.asarray(0.0))
    select = get_strategy("uncertainty_sampling")

    @jax.jit
    def round_step(st, key):
        k_sel, k_user = jax.random.split(key)
        batch = select(st, dst.BATCH, k_sel, params)
        yb, valid = simulate_feedback(k_user, batch, relevant, params.label_prob,
                                      params.mistake_prob)
        return gp_mod.gp_update(st, batch, yb, valid)

    key = jax.random.PRNGKey(seed)
    for rnd in range(1, rounds + 1):
        state = round_step(state, jax.random.fold_in(key, rnd))
    return np.asarray(state.idx)[:int(state.count)].tolist()


def test_drift_labels_the_reference_protocol_and_keeps_its_row_keys(tmp_path):
    out = tmp_path / "drift_torch.json"
    assert dst.main(["--device", "cpu", "--n", "2000", "--rounds", "12", "--every", "4",
                     "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    want_rows = json.loads((ROOT / "results" / "drift_study_noisy.json").read_text())["rows"]
    assert [set(r) for r in rec["rows"]] == [set(want_rows[0])] * 3
    assert [r["round"] for r in rec["rows"]] == [4, 8, 12]
    assert rec["labeled_idx"] == _jax_drift_labels(dst.corpus(2000), 12)
    for r in rec["rows"]:
        assert r["mu_inf_inc"] <= 1e-4 and r["top100_overlap_inc"] >= 0.95
    ref_keys = {"corpus", "n", "dim", "cap", "batch", "rounds", "seed", "strategy", "user",
                "platform", "matmul_precision", "hyper", "wall_s", "rows"}  # drift_study.py's
    assert ref_keys | {"device", "power_limit", "labeled_idx"} == set(rec)


def test_drift_oracle_is_the_reference_oracle():
    ref = _reference("drift_study")
    rng = np.random.default_rng(1)
    x64 = rng.random((700, 16)) * 20.0
    idx = rng.permutation(700)[:40]
    y = np.where(rng.random(40) < 0.5, 1.0, -1.0).astype(np.float32)
    valid = rng.random(40) < 0.8
    for count in (1, 25, 40):
        got = dst.oracle_posterior(x64, idx, y, valid, count, block=256)
        want = ref.oracle_posterior(x64, idx, y, valid, count, block=256)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)


def test_drift_corpus_is_the_reference_surrogate():
    from ital_tpu.data import datasets as jds

    want = jds._synthetic_surrogate("mirflickr", 2000, 512, 14)
    got = dst.corpus(2000)
    assert np.array_equal(got.x, want.x) and np.array_equal(got.relevance, want.relevance)


# ---------------------------------------------------------------------------
# record_bigcap_session_torch
# ---------------------------------------------------------------------------


def test_bigcap_session_takes_the_large_cap_path_on_gloo(tmp_path):
    proc = subprocess.run(
        [sys.executable, str(SCRIPTS / "record_bigcap_session_torch.py"), "DATA.n=3000",
         "DATA.dim=128", "GP.length_scale=12", "METHOD.pool_size=256",
         "EXPERIMENT.mesh_devices=2", "--tag", "small", "--device", "cpu",
         "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads((tmp_path / "bigcap_session_100k_small_torch.json").read_text())
    want = json.loads((ROOT / "results" / "bigcap_session_100k_fastsel.json").read_text())
    assert rec["chol2d"] is True and rec["mesh_devices"] == 2 and rec["cap"] == 1024
    assert set(want) | {"device", "power_limit"} == set(rec)
    assert [r["round"] for r in rec["per_round"]] == [0, 1, 2]
    assert all(np.isfinite(r["ap"]) and r["round_ms"] > 0 for r in rec["per_round"])


# ---------------------------------------------------------------------------
# ital_regression's wide solve goes through tri_solve
# ---------------------------------------------------------------------------


def _spy_tri_solve(monkeypatch):
    """Record each ``tri_solve`` call's right-hand side shape, and hold its
    result bit-equal to the direct left-side solve it replaced."""
    from ital_tpu_torch.ops import chol as chol_ops

    real, calls = chol_ops.tri_solve, []

    def spy(l, b, **kw):
        out = real(l, b, **kw)
        if not kw.get("trans"):
            calls.append(tuple(b.shape))
            assert torch.equal(out, torch.linalg.solve_triangular(l, b, upper=False))
        return out

    monkeypatch.setattr(chol_ops, "tri_solve", spy)
    return calls


def _regression_state(n=600, d=8, cap=16):
    from ital_tpu_torch.models import gp as tgp

    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    st = tgp.gp_set_query(tgp.gp_init(x, 2.0, 1.0, 0.1, cap), 3)
    tgp.gp_update(st, torch.tensor([10, 20, 30]), torch.tensor([1.0, -1.0, 1.0]),
                  torch.ones(3, dtype=torch.bool))
    return st


def test_ital_regression_solves_through_tri_solve(monkeypatch):
    from ital_tpu_torch.select.base import StrategyParams
    from ital_tpu_torch.select.regression import select_ital_regression

    st = _regression_state()
    params = StrategyParams.create("cpu")
    want = select_ital_regression(st, 4, None, params)
    calls = _spy_tri_solve(monkeypatch)
    got = select_ital_regression(st, 4, None, params)
    assert [c for c in calls if c[-1] == st.x.shape[0]] == [(1, t, st.x.shape[0]) for t in (1, 2, 3)]
    assert torch.equal(got, want)


def test_sharded_ital_regression_solves_through_tri_solve(monkeypatch):
    from ital_tpu_torch import graphs
    from ital_tpu_torch.parallel import make_mesh
    from ital_tpu_torch.parallel import sharded as sh
    from ital_tpu_torch.select.base import StrategyParams

    st = _regression_state()
    params = StrategyParams.create("cpu")
    pad = torch.zeros(st.x.shape[0], dtype=torch.bool)
    with make_mesh(1, device="cpu") as mesh:
        local = sh.shard_state(st, mesh)
        select = sh.make_sharded_select(mesh, strategy="ital_regression", batch_size=4)
        with graphs.eager():
            want = select(local, torch.Generator(), pad, params)
            calls = _spy_tri_solve(monkeypatch)
            got = select(local, torch.Generator(), pad, params)
    assert [c for c in calls if c[-1] == st.x.shape[0]] == [(1, t, st.x.shape[0]) for t in (1, 2, 3)]
    assert torch.equal(got, want)

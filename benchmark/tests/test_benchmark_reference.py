"""The plain reference against the port at a small size on the CPU."""

import numpy as np
import pytest
import torch

import benchtiny  # noqa: F401
from benchmark import harness
from benchmark import reference as ref
from benchmark.corpus import surrogate

SPEC = {"gp": {"length_scale": 50.0, "var": 1.0, "noise": 0.1},
        "user": {"label_prob": 0.8, "mistake_prob": 0.05},
        "selection": {"strategy": "ital", "pool_size": 256, "n_qmc": 32, "refine_top": 16,
                      "refine_n_qmc": 512}}
ITAL = harness.load_module(harness.reference_path("ital"))
OPTS = dict(pool_size=256, n_qmc=32, refine_top=16, refine_n_qmc=512)


@pytest.fixture(scope="module")
def served():
    """A port session driven 5 rounds, with its labels and batches."""
    from ital_tpu_torch.models.session import ActiveRetrieval

    x, _ = surrogate(3000, 512, 14, 11, "cpu")
    s = ActiveRetrieval(x, length_scale=50.0, var=1.0, noise=0.1, cap=64, label_prob=0.8,
                        mistake_prob=0.05, method_kwargs=OPTS, device="cpu")
    s.update_query(17)
    rng = np.random.default_rng(1)
    idx, y, sampled = [17], [1.0], []
    for _ in range(5):
        batch = [int(i) for i in s.fetch_unlabelled(4)]
        sampled.append((list(idx), list(y), batch))
        fb = {i: int(rng.choice([-1, 0, 1])) for i in batch}
        s.update(fb)
        for i, a in fb.items():
            if a:
                idx.append(i)
                y.append(float(a))
    return x, s, idx, y, sampled


def test_posterior_and_picks_match_the_port(served):
    x, s, idx, y, sampled = served
    r = ref.readings(x, SPEC, [(idx, y, s.state.mu, s.state.sig2)], sampled, ITAL.readings)
    assert r["posterior_err"] < 1e-5
    assert r["select_gap"] < 1e-6


def test_lower_precisions_read_higher(served):
    x, s, idx, y, sampled = served
    sound = ref.readings(x, SPEC, [(idx, y, s.state.mu, s.state.sig2)], sampled,
                         ITAL.readings)
    for control in ("tf32", "fp8_corpus"):
        low = ref.readings(x, SPEC, [(idx, y, None, None)], sampled, ITAL.readings,
                           control=control)
        assert low["posterior_err"] > 30 * sound["posterior_err"], control


def test_a_labeled_or_repeated_pick_is_invalid(served):
    x, s, idx, y, sampled = served
    i0, y0, batch = sampled[1]
    bad = [batch[0], batch[0], batch[2], batch[3]]
    assert ref.readings(x, SPEC, [], [(i0, y0, bad)], ITAL.readings)["select_gap"] == \
        ref.INVALID_GAP
    bad = [i0[0], batch[1], batch[2], batch[3]]
    assert ref.readings(x, SPEC, [], [(i0, y0, bad)], ITAL.readings)["select_gap"] == \
        ref.INVALID_GAP


def test_estimator_matches_the_port_tree():
    from ital_tpu_torch.ops import mvn

    g = torch.Generator().manual_seed(3)
    for m in (1, 2, 4):
        a = torch.randn(40, m, m, generator=g, dtype=torch.float64)
        cov = a @ a.mT + 0.5 * torch.eye(m, dtype=torch.float64)
        mu = torch.randn(40, m, generator=g, dtype=torch.float64)
        port = mvn.orthant_probs_all_configs_tree(mu, mvn.small_cholesky(cov), n_points=128)
        signs, _ = ITAL.mi_tables(m, 0.8, 0.05, torch.float64, "cpu")
        mine = ITAL.orthant_probs(mu, ITAL.small_cholesky(cov), signs, 128)
        assert (port - mine).abs().max() < 1e-8


def test_tf32_rounding():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 2**-9, 3.0])
    assert ref.tf32_round(x).tolist() == [1.0 + 2**-10, 1.0 + 2**-9, 3.0]

"""The lower-precision controls, and faults planted under the timed path,
each come out as not correct; sound runs come out correct."""

import pytest
import torch

import benchtiny
from benchmark import control, harness


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return benchtiny.tiny_copy(str(tmp_path_factory.mktemp("bench")))


def test_controls_fail_their_limits(root):
    rows = list(control.readings("tiny.tinycohort", [5, 6], 2, 3.0, "cpu", root=root))
    limits = harness.resolve("tiny.tinycohort", root).config["correct"]["limits"]
    for row in rows:
        assert row["correct"] is True
        assert all(row["program"][k] <= v for k, v in limits.items())
        for name, got in row["controls"].items():
            assert any(got[k] > v for k, v in limits.items()), (name, got)


def _unchanged(states, new_idx, new_y, new_valid):
    for s in states:
        s.count += new_idx.shape[-1]


def _half(states, new_idx, new_y, new_valid, real=None):
    h = max(1, len(states) // 2)
    real(states[:h], new_idx[:h], new_y[:h], new_valid[:h])
    _unchanged(states[h:], new_idx[h:], new_y[h:], new_valid[h:])


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch", "pick_altered"])
def test_faults_under_the_timed_path_are_not_correct(root, monkeypatch, fault):
    from ital_tpu_torch import serve
    from ital_tpu_torch.models import gp

    if fault == "state_unchanged":
        monkeypatch.setattr(gp, "update_stacked", _unchanged)
    elif fault == "half_the_batch":
        real = gp.update_stacked
        monkeypatch.setattr(gp, "update_stacked", lambda *a: _half(*a, real=real))
    else:
        many = serve.RetrievalService.next_batch_many

        def altered(self, sids, k):
            out = many(self, sids, k)
            n = self.x.shape[0]
            return {sid: b[:-1] + [(b[-1] + n // 2) % n] for sid, b in out.items()}

        monkeypatch.setattr(serve.RetrievalService, "next_batch_many", altered)
    out = harness.run("tiny.tinycohort", 9, 3.0, False, "cpu", 0.0, root=root)
    assert out["correct"] is False, out["compared"]


@pytest.mark.cuda
def test_controls_on_the_card(root):
    """The same readings on the card, at the small cells' size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rows = list(control.readings("tiny.tinycohort", [5], 1, 3.0, "cuda", root=root))
    limits = harness.resolve("tiny.tinycohort", root).config["correct"]["limits"]
    assert rows[0]["correct"] is True
    for got in rows[0]["controls"].values():
        assert any(got[k] > v for k, v in limits.items())

"""The frozen roofline bounds, and the mixes' RBF launch tables against the
blocks the port forms on the CPU."""

import collections
import types

import pytest
import torch

import benchtiny
from benchmark.roofline import blocks, rbf_bound_ms, sizes_of


def test_bounds_of_the_frozen_copy():
    ms, by = rbf_bound_ms(64, 25000, 512, False, norms=25000)
    assert round(ms * 1e3, 2) == 17.26 and by == "bytes"
    ms, by = rbf_bound_ms(4, 1_000_000, 512, True, norms=1_000_000)
    assert round(ms * 1e3, 2) == 311.64 and by == "bytes"


@pytest.mark.parametrize("cell", benchtiny.CELLS)
def test_launch_tables_match_the_port(tmp_path, monkeypatch, cell):
    """Every RBF block the port forms on the CPU (the plain version counted
    in place of the kernels) is one the launch tables list for the calls the
    window made, and no other."""
    from benchmark import harness
    from ital_tpu_torch.ops import kernels

    root = benchtiny.tiny_copy(str(tmp_path))
    seen = collections.Counter()
    forward = kernels._rbf_forward

    def counting(a, b, length_scale, var, a2, b2, out=None):
        same = a.shape == b.shape and torch.equal(a, b)  # b is a's rows
        seen[(a.shape[0], b.shape[0], same, b2 is not None)] += 1
        return forward(a, b, length_scale, var, a2, b2, out)

    records = []
    real_turn = harness.Loop.turn

    def turn(self):
        if not records:
            records.append(self.rec)
            seen.clear()  # the warm-up's blocks are set-up's
        return real_turn(self)

    monkeypatch.setattr(kernels, "_rbf_forward", counting)
    monkeypatch.setattr(harness.Loop, "turn", turn)
    harness.run(cell, 7, 2.0, False, "cpu", 0.0, root=root)
    rec = records[0]
    cfg = rec.cell.config
    want = blocks(rec.calls, sizes_of(cfg), cfg["selection"]["strategy"], root)
    assert sum(want.values()) == sum(seen.values())
    assert want == seen


def test_a_kind_without_a_table_reads_nothing():
    sizes = {"N": 100, "D": 8, "C": 4, "P": 10, "B": 4}
    assert blocks([("select_many", 2, False)], sizes, "emoc", benchtiny.ROOT) is None
    got = blocks([("feedback", 1, True)], sizes, "ital", benchtiny.ROOT)
    assert got == {(4, 4, False, False): 2, (4, 4, True, False): 2, (4, 100, False, True): 2}


def _rec(trace, calls, cfg):
    cell = types.SimpleNamespace(config=cfg, root=benchtiny.ROOT)
    return types.SimpleNamespace(trace=trace, calls=calls, cell=cell, log=lambda msg: None)


def test_roofline_share_from_the_stretch():
    """Bounds of the stretch's calls over its RBF records' device time; the
    records a profile dropped stand at their mean; a count the tables do not
    give, or too many records dropped, read nothing."""
    from benchmark import harness

    read = harness.load_reader("rbf_roofline_pct")
    cfg = harness.resolve("mirflickr1m_bf16.single").config
    calls = [("start", 1, False), ("feedback", 1, False), ("select", 1, False)]
    want = blocks(calls[1:], sizes_of(cfg), "ital", benchtiny.ROOT)
    bound = sum(rbf_bound_ms(m, n, 512, True, norms=n if norms else 0, same=same)[0] * c
                for (m, n, same, norms), c in want.items()) / 1e3
    launches = sum(want.values())
    trace = {"window_s": 3.0, "busy_s": 1.0, "calls": [1, 3], "launches": launches,
             "kernel_records": launches, "kernel_s": 2 * bound}
    assert read(_rec(trace, calls, cfg)) == pytest.approx(50.0)
    short = {**trace, "launches": 100, "kernel_records": 99, "kernel_s": 2 * bound * 0.99}
    assert read(_rec(short, calls, cfg)) is None  # the tables give fewer
    assert read(_rec({**trace, "calls": [0, 3]}, calls, cfg)) is None
    assert read(_rec({**trace, "kernel_records": launches - 1}, calls, cfg)) is None

"""The traffic generator: the same seed gives the same sessions and answers."""

import numpy as np

import benchtiny  # noqa: F401  (puts the repository root on sys.path)
from benchmark.generator import Traffic, user_answers

MIX = {"slots": 8, "path": "cohort", "rounds": [5, 15]}
LABELS = np.random.default_rng(0).integers(0, 14, size=5000)
SEED = 2**31 + 12345


def _sessions(seed, per_slot=3):
    t = Traffic(MIX, seed, LABELS, 14)
    out = []
    for slot in range(8):
        for _ in range(per_slot):
            s = t.next_session(slot)
            batch = list(range(4 * s.number, 4 * s.number + 4))
            out.append((s.slot, s.topic, s.query, s.rounds,
                        tuple(t.answer(s, batch, 0.8, 0.05))))
    return out


def test_same_seed_same_traffic():
    assert _sessions(SEED) == _sessions(SEED)
    assert _sessions(SEED) != _sessions(SEED + 1)


def test_queries_are_of_their_topic():
    t = Traffic(MIX, SEED, LABELS, 14)
    for slot in range(8):
        s = t.next_session(slot)
        assert LABELS[s.query] == s.topic


def test_lengths_are_permutations_of_the_range():
    t = Traffic(MIX, SEED, LABELS, 14)
    lengths = [t.next_session(0).rounds for _ in range(22)]
    assert sorted(lengths) == sorted(list(range(5, 16)) * 2)


def test_slots_are_staggered_and_widths_vary():
    t = Traffic(MIX, SEED, LABELS, 14)
    firsts = {t.next_session(slot).rounds for slot in range(8)}
    assert len(firsts) > 1
    widths = Traffic(MIX, SEED, LABELS, 14).feedback_widths(500)
    assert max(widths) == 8 and len(widths) > 1


def test_user_answers_follow_the_frozen_user():
    rel = np.array([True, False, True, False])
    # label, label, skip, label; the second flipped
    got = user_answers(np.array([0.1, 0.5, 0.9, 0.2]), np.array([0.5, 0.01, 0.5, 0.9]),
                       rel, 0.8, 0.05)
    assert got == [1, 1, 0, -1]

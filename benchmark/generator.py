"""The one traffic generator: searchers' sessions and the simulated user's
answers, from a mix's parameters and the run's seed.

A mix (``benchmark/traffic/<name>.json``) is a closed loop of ``slots``
searchers with no think time, served through ``path`` (:mod:`benchmark.harness`
holds the paths; a mix with code of its own serves its turn instead):
``cohort`` sends all slots' feedback in one ``feedback_many`` and asks for all
their batches in one ``next_batch_many``; ``single`` serves each slot in turn
through ``feedback`` and ``next_batch``.  Each searcher runs one session after another:
a query row drawn from a seeded topic, then R rounds of a batch (of the
configuration's size) shown and answered, then the session is deleted and the
next one starts.  A slot's session lengths are successive random permutations of
``rounds[0] .. rounds[1]``, so every seed serves the same multiset of lengths
in another order, and the slots start and end at different times.

Every draw is a NumPy generator keyed by (seed, slot, session): the same seed
gives the same queries, lengths and answer draws however fast the system
runs.  The answers depend on the batches the system returns, through the
simulated user below.

The simulated user is a frozen copy of ``ital_tpu_torch/data/user.py::
feedback_from_uniforms`` (the paper's noisy, skipping user): for each shown
item, two uniforms in that order, ``u_label`` for all items then ``u_flip``;
the item is answered with probability ``label_prob``, the answer (+1 where
the item shares the query's topic, else -1) flipped with probability
``mistake_prob``, and a skipped item is sent as 0.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def _seq(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2**64, *keys])


def user_answers(u_label: np.ndarray, u_flip: np.ndarray, relevant: np.ndarray,
                 label_prob: float, mistake_prob: float) -> list[int]:
    """The user's answers (+1, -1, or 0 for a skip) to items whose truth is
    ``relevant`` (bool), from the two uniform vectors."""
    truth = np.where(relevant, 1, -1)
    y = np.where(u_flip < mistake_prob, -truth, truth)
    return [int(v) for v in np.where(u_label < label_prob, y, 0)]


@dataclasses.dataclass
class Session:
    """One searcher's session and what it was shown and answered."""

    slot: int
    number: int  # the slot's session count before this one
    topic: int
    query: int
    rounds: int
    rng: np.random.Generator  # the user's answer draws
    sid: Optional[str] = None  # the service's id, while live
    batches: list = dataclasses.field(default_factory=list)  # each shown batch
    answers: list = dataclasses.field(default_factory=list)  # answers absorbed, per batch

    @property
    def done(self) -> bool:
        return len(self.answers) >= self.rounds

    def labels(self, upto: Optional[int] = None) -> tuple[list[int], list[float]]:
        """The labeled rows and labels the service holds after absorbing the
        first ``upto`` answered batches (all where None): the query as +1,
        then every answered item; skips hold no label."""
        idx, y = [self.query], [1.0]
        for batch, ans in zip(self.batches, self.answers[:upto]):
            for i, a in zip(batch, ans):
                if a != 0:
                    idx.append(int(i))
                    y.append(float(a))
        return idx, y


class Traffic:
    """Sessions of a mix over a corpus whose class labels are ``labels``."""

    def __init__(self, params: dict, seed: int, labels: np.ndarray, n_classes: int):
        self.params = params
        self.slots = int(params["slots"])
        self.lo, self.hi = (int(v) for v in params["rounds"])
        self.seed = int(seed)
        self.labels = np.asarray(labels)
        order = np.argsort(self.labels, kind="stable")
        bounds = np.searchsorted(self.labels[order], np.arange(n_classes + 1))
        self.by_topic = [order[bounds[c]:bounds[c + 1]] for c in range(n_classes)]
        self.topics = [c for c in range(n_classes) if len(self.by_topic[c])]
        self._lengths = [self._length_stream(s) for s in range(self.slots)]
        self._count = [0] * self.slots

    def _length_stream(self, slot: int):
        rng = _seq(self.seed, 1, slot)
        values = np.arange(self.lo, self.hi + 1)
        while True:
            yield from (int(v) for v in rng.permutation(values))

    def _query(self, rng: np.random.Generator) -> tuple[int, int]:
        topic = self.topics[int(rng.integers(len(self.topics)))]
        rows = self.by_topic[topic]
        return topic, int(rows[int(rng.integers(len(rows)))])

    def next_session(self, slot: int) -> Session:
        k = self._count[slot]
        self._count[slot] += 1
        rng = _seq(self.seed, 2, slot, k)
        topic, query = self._query(rng)
        return Session(slot=slot, number=k, topic=topic, query=query,
                       rounds=next(self._lengths[slot]), rng=rng)

    def feedback_widths(self, turns: int) -> set:
        """The numbers of slots that send feedback in one turn, over the
        first ``turns`` turns of the cohort loop: a session of R rounds holds
        its slot for R + 1 turns, its start and then R feedback turns."""
        widths = np.zeros(turns, dtype=np.int64)
        for slot in range(self.slots):
            lengths, t = self._length_stream(slot), 0
            while t < turns:
                r = next(lengths)
                widths[t + 1:t + 1 + r] += 1
                t += r + 1
        return {int(w) for w in widths if w}

    def warm_queries(self, count: int) -> list[int]:
        """Query rows for the set-up's warm-up sessions, from a stream of
        their own."""
        rng = _seq(self.seed, 3)
        return [self._query(rng)[1] for _ in range(count)]

    def answer(self, sess: Session, batch: list, label_prob: float,
               mistake_prob: float) -> list[int]:
        """The user's answers to ``batch``, drawn from the session's stream."""
        u_label = sess.rng.random(len(batch))
        u_flip = sess.rng.random(len(batch))
        relevant = self.labels[np.asarray(batch, dtype=np.int64)] == sess.topic
        return user_answers(u_label, u_flip, relevant, label_prob, mistake_prob)

"""Strategy interface and registry (port of ``ital_tpu.select.base``).

A strategy is a function over the GP state::

    select(state: GPState, batch_size, generator, params: StrategyParams) -> (b,) int64

returning the next batch of corpus indices to show the user, on the state's
device.  ``generator`` (a ``torch.Generator`` on that device) feeds
strategies with random components; deterministic strategies ignore it.

Its stacked form selects for a cohort of K sessions over one corpus::

    select(states, batch_size, generators, params) -> (K, b) int64

with one generator per session (:func:`get_stacked_strategy`), ``states``
the K sessions' own states.  A strategy whose stacked selection can run
inside a cohort program (ITAL's) also registers it as a
:class:`CohortProgram` (:func:`cohort_program`): the runner's cohort rounds
capture it with the update, whatever the strategy.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Dict, Optional

import torch

from ital_tpu_torch.models.gp import GPState, StackedGPState


@dataclasses.dataclass
class StrategyParams:
    """Per-strategy hyperparameters as 0-d float32 tensors on the state's device.

    ``tradeoff`` weighs the two criteria of the density/diversity baselines.
    """

    label_prob: torch.Tensor
    mistake_prob: torch.Tensor
    jitter: torch.Tensor
    tradeoff: torch.Tensor

    @classmethod
    def create(
        cls,
        device,
        *,
        label_prob: float = 1.0,
        mistake_prob: float = 0.0,
        jitter: float = 1e-6,
        tradeoff: float = 0.5,
    ) -> "StrategyParams":
        def t(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        return cls(label_prob=t(label_prob), mistake_prob=t(mistake_prob), jitter=t(jitter),
                   tradeoff=t(tradeoff))

    def program_inputs(self) -> dict:
        """The values by name, as a program's inputs
        (:func:`ital_tpu_torch.graphs.run`)."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}

    @classmethod
    def from_inputs(cls, inputs: dict) -> "StrategyParams":
        """The params a program's body works on, from its ``inputs``."""
        return cls(**{f.name: inputs[f.name] for f in dataclasses.fields(cls)})


SelectFn = Callable[..., torch.Tensor]

STRATEGIES: Dict[str, SelectFn] = {}


def register(name: str):
    def deco(fn: SelectFn) -> SelectFn:
        STRATEGIES[name] = fn
        return fn

    return deco


def get_strategy(name: str) -> SelectFn:
    try:
        return STRATEGIES[name]
    except KeyError:
        raise KeyError(
            f"unknown strategy {name!r}; available: {sorted(STRATEGIES)}"
        ) from None


# Strategies with a stacked form of their own (ITAL's select_ital_stacked).
STACKED: Dict[str, SelectFn] = {}


def register_stacked(name: str):
    def deco(fn: SelectFn) -> SelectFn:
        STACKED[name] = fn
        return fn

    return deco


def get_stacked_strategy(name: str) -> SelectFn:
    """The stacked form of strategy ``name``: its own where it has one, else
    a loop of the strategy over the stack's sessions, one after another,
    with the same options and the same results."""
    select = get_strategy(name)
    if name in STACKED:
        return STACKED[name]

    def each_session(states, batch_size, generators, params, **kwargs):
        return torch.stack([select(s, batch_size, g, params, **kwargs)
                            for s, g in zip(states, generators)])

    return each_session


@dataclasses.dataclass(frozen=True)
class CohortProgram:
    """A strategy's stacked selection as the body of a cohort program: its
    random inputs drawn before the program runs, its picks made inside.

    ``static``: the hashable options the body closes over (part of the
    program's signature); ``draw(generators, n, dtype, device)``: the K
    sessions' random inputs, session k's from ``generators[k]`` in the
    order its own selection draws, as named (K, ...) tensors or None;
    ``picks(st, params, **drawn)``: the (K, b) picks of a
    :class:`StackedGPState` with those inputs fed in."""

    static: tuple
    draw: Callable[..., dict]
    picks: SelectFn


# name -> (batch_size, the strategy's options) -> its CohortProgram.
COHORT_PROGRAMS: Dict[str, Callable[[int, dict], CohortProgram]] = {}


def register_cohort_program(name: str):
    def deco(fn: Callable[[int, dict], CohortProgram]) -> Callable[[int, dict], CohortProgram]:
        COHORT_PROGRAMS[name] = fn
        return fn

    return deco


def cohort_program(name: str, batch_size: int, options: dict) -> Optional[CohortProgram]:
    """Strategy ``name``'s stacked selection of ``batch_size`` with
    ``options`` as a cohort program's body, or None where it has none (its
    stacked form then runs eagerly before the program)."""
    get_strategy(name)
    make = COHORT_PROGRAMS.get(name)
    return None if make is None else make(batch_size, options)


def declared_method_kwargs(name: str) -> frozenset:
    """Names of the keyword-only options strategy ``name`` declares."""
    sig = inspect.signature(get_strategy(name))
    return frozenset(n for n, p in sig.parameters.items()
                     if p.kind is inspect.Parameter.KEYWORD_ONLY)


def filter_method_kwargs(name: str, kwargs: dict) -> dict:
    """Drop options strategy ``name`` does not declare (for shared defaults)."""
    declared = declared_method_kwargs(name)
    return {k: v for k, v in kwargs.items() if k in declared}


def validate_method_kwargs(name: str, kwargs: dict) -> None:
    """Reject options strategy ``name`` does not declare (a typo fails loudly)."""
    declared = declared_method_kwargs(name)
    unknown = sorted(set(kwargs) - declared)
    if unknown:
        raise ValueError(
            f"unknown method_kwargs for strategy {name!r}: {unknown}; "
            f"declared options: {sorted(declared)}"
        )


def labeled_mask(state: GPState | StackedGPState) -> torch.Tensor:
    """(N,) bool — True at corpus indices that must not be selected again;
    (K, N) for a stack of K sessions.

    Only valid labels are excluded: skipped items stay in the candidate pool.
    """
    hits = torch.zeros((*state.idx.shape[:-1], state.x.shape[0]), dtype=torch.int32,
                       device=state.idx.device)
    return hits.scatter_add_(-1, state.idx, state.active.to(torch.int32)) > 0


def greedy_argmax_batch(score_fn, state: GPState, batch_size: int) -> torch.Tensor:
    """Greedy batch construction: repeatedly argmax a per-candidate score.

    ``score_fn(batch, t) -> (N,) scores`` may depend on ``batch[:t]``;
    labeled and already-picked candidates are masked to -inf.  Ties go to the
    lowest index, as ``jnp.argmax``.
    """
    excluded = labeled_mask(state)
    batch = torch.zeros(batch_size, dtype=torch.int64, device=state.idx.device)
    for t in range(batch_size):
        scores = torch.where(excluded, -torch.inf, score_fn(batch, t))
        nxt = torch.argmax(scores)
        batch[t] = nxt
        excluded[nxt] = True
    return batch

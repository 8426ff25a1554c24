"""Strategy interface and registry (port of ``ital_tpu.select.base``).

A strategy is a function over the GP state::

    select(state: GPState, batch_size, generator, params: StrategyParams) -> (b,) int64

returning the next batch of corpus indices to show the user, on the state's
device.  ``generator`` (a ``torch.Generator`` on that device) feeds
strategies with random components; deterministic strategies ignore it.

Its stacked form selects for a cohort of K sessions over one corpus::

    select(st: StackedGPState, batch_size, generators, params) -> (K, b) int64

with one generator per session (:func:`get_stacked_strategy`).
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Dict

import torch

from ital_tpu_torch.models.gp import GPState, StackedGPState, session_state


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

    def each_session(st: StackedGPState, batch_size, generators, params, **kwargs):
        return torch.stack([select(session_state(st, k), batch_size, g, params, **kwargs)
                            for k, g in enumerate(generators)])

    return each_session


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

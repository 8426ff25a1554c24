"""Strategy interface and registry (port of ``ital_tpu.select.base``).

A strategy is a function over the GP state::

    select(state: GPState, batch_size, generator, params: StrategyParams) -> (b,) int64

returning the next batch of corpus indices to show the user, on the state's
device.  ``generator`` (a ``torch.Generator`` on that device) feeds
strategies with random components; deterministic strategies ignore it.

Its stacked form selects for a cohort of K sessions over one corpus::

    select(states, batch_size, generators, params) -> (K, b) int64

with one generator per session (:func:`get_stacked_strategy`), ``states``
the K sessions' own states and ``params`` one user model for all or the
K sessions' own (:meth:`StrategyParams.stack`).

Every strategy's selection is a program (:mod:`ital_tpu_torch.graphs`), the
counterpart of the reference's jitted ``select`` and its ``jax.vmap``: one
body over a :class:`StackedGPState`, registered as a :class:`CohortProgram`
(:func:`cohort_program`), serves the single-session fetch (a stack of one),
the stacked selection and the runner's cohort and fused programs.  Its
random inputs are drawn before the program, each session's from its own
generator in the order its own selection draws, and fed in.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
from typing import Callable, Dict, Sequence

import torch

from ital_tpu_torch import graphs
from ital_tpu_torch.models.gp import (
    GPState,
    StackedGPState,
    cohort_program_inputs,
    program_inputs,
    program_shared,
    program_stack,
    program_state,
    stacked_view,
)


@dataclasses.dataclass
class StrategyParams:
    """Per-strategy hyperparameters as 0-d float32 tensors on the state's device.

    ``tradeoff`` weighs the two criteria of the density/diversity baselines.
    A stacked selection also takes them as (K,) tensors, one value per
    session (:meth:`stack`).
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

    @classmethod
    def stack(cls, params: Sequence["StrategyParams"]) -> "StrategyParams":
        """K sessions' params as one with (K,) fields, session k's values at
        k (the reference's ``params_b``)."""
        return cls(**{f.name: torch.stack([getattr(p, f.name) for p in params])
                      for f in dataclasses.fields(cls)})


def per_session(v: torch.Tensor, dims: int = 1) -> torch.Tensor:
    """A 0-d value as it is, or (K,) per-session values as (K, 1, ...) with
    ``dims`` trailing axes, to scale K sessions' (K, ...) tensors."""
    return v if v.dim() == 0 else v.reshape(*v.shape, *(1,) * dims)


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


# name -> its stacked selection (select_ital_stacked for ITAL, else
# select_stacked of the strategy's program).
STACKED: Dict[str, SelectFn] = {}


def register_stacked(name: str):
    def deco(fn: SelectFn) -> SelectFn:
        STACKED[name] = fn
        return fn

    return deco


def get_stacked_strategy(name: str) -> SelectFn:
    """The stacked form of strategy ``name``: one program for the K
    sessions, each row the batch the strategy picks for that session
    alone."""
    get_strategy(name)
    return STACKED[name]


def each_session(name: str) -> SelectFn:
    """The stacked form of strategy ``name`` as a loop of its
    single-session selection over the sessions, one after another: the
    oracle the stacked programs are held to.  ``params`` is one
    :class:`StrategyParams` for all or a sequence of the K sessions'."""
    select = get_strategy(name)

    def loop(states, batch_size, generators, params, **kwargs):
        each = params if isinstance(params, (list, tuple)) else [params] * len(states)
        return torch.stack([select(s, batch_size, g, p, **kwargs)
                            for s, g, p in zip(states, generators, each)])

    return loop


@dataclasses.dataclass(frozen=True)
class CohortProgram:
    """A strategy's stacked selection as the body of a program: its random
    inputs drawn before the program runs, its picks made inside.

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


def cohort_program(name: str, batch_size: int, options: dict) -> CohortProgram:
    """Strategy ``name``'s stacked selection of ``batch_size`` with
    ``options`` as a program's body."""
    get_strategy(name)
    return COHORT_PROGRAMS[name](batch_size, options)


def no_draws(generators, n, dtype, device) -> dict:
    """The random inputs of a strategy that draws nothing."""
    return {}


def register_program(name: str, body: SelectFn, *, draw: Callable[..., dict] = no_draws,
                     drawn: tuple = ()) -> SelectFn:
    """Register ``body`` as strategy ``name`` and return its selection.

    ``body(st, params, *, batch_size, <options>, <drawn>) -> (K, b)`` picks
    the K sessions of a :class:`StackedGPState` with ``params`` 0-d or
    (K,); its other keyword-only arguments are the strategy's options, but
    for ``drawn``, the names of the (K, ...) random inputs ``draw`` makes
    (:class:`CohortProgram`).  Registered: the body as the strategy's
    cohort program, the single-session selection (returned, with the
    options in its signature) and the stacked one (:func:`select_stacked`).
    """
    params = inspect.signature(body).parameters.values()
    options = [p for p in params if p.kind is inspect.Parameter.KEYWORD_ONLY
               and p.name != "batch_size" and p.name not in drawn]

    def make(batch_size: int, opts: dict) -> CohortProgram:
        return CohortProgram(static=(name, tuple(sorted(opts.items()))), draw=draw,
                             picks=functools.partial(body, batch_size=batch_size, **opts))

    def select(state, batch_size, generator, params, **opts):
        return select_program(name, state, batch_size, generator, params, **opts)

    positional = [inspect.Parameter(n, inspect.Parameter.POSITIONAL_OR_KEYWORD)
                  for n in ("state", "batch_size", "generator", "params")]
    select.__signature__ = inspect.Signature(positional + options)
    select.__name__ = select.__qualname__ = f"select_{name}"
    select.__doc__ = body.__doc__
    COHORT_PROGRAMS[name] = make
    STACKED[name] = functools.partial(select_stacked, name)
    return register(name)(select)


def _drawn_inputs(inputs: dict, drawn: tuple) -> dict:
    return {k: inputs.pop(k) for k in drawn}


def _select_body(x, density=None, *, picks, drawn, **inputs) -> tuple[torch.Tensor]:
    """The single-session selection program's body: ``picks`` of the
    session as a stack of one, its draws fed in."""
    fed = {k: None if v is None else v[None] for k, v in _drawn_inputs(inputs, drawn).items()}
    st = stacked_view(program_state(x, inputs, density))
    return (picks(st, StrategyParams.from_inputs(inputs), **fed)[0],)


def _stacked_body(x, density=None, *, picks, drawn, groups, **inputs) -> tuple[torch.Tensor]:
    """The stacked selection program's body: ``picks`` of the stack of the
    inputs, its draws fed in."""
    fed = _drawn_inputs(inputs, drawn)
    st = program_stack(x, inputs, groups, density)
    return (picks(st, StrategyParams.from_inputs(inputs), **fed),)


def select_program(name: str, state: GPState, batch_size: int, generator, params: StrategyParams,
                   **options) -> torch.Tensor:
    """Strategy ``name``'s (batch_size,) pick for ``state`` as one program
    (the reference's ``_jit_select``): on the card a graph captured once per
    strategy, batch size, options, corpus and shapes and shared by every
    session, its draws made first and fed in; on the CPU, or in
    ``graphs.eager()``, the same body runs eagerly."""
    prog = cohort_program(name, batch_size, options)
    drawn = prog.draw([generator], state.x.shape[0], state.mu.dtype, state.mu.device)
    inputs = {**program_inputs(state), **params.program_inputs(),
              **{k: None if v is None else v[0] for k, v in drawn.items()}}
    (batch,) = graphs.run(
        f"select_{name}", functools.partial(_select_body, picks=prog.picks, drawn=tuple(drawn)),
        inputs, shared=program_shared(state), static=(batch_size, prog.static))
    return batch


def select_stacked(name: str, states: Sequence[GPState], batch_size: int, generators,
                   params: StrategyParams, **options) -> torch.Tensor:
    """Strategy ``name``'s (K, batch_size) picks of the K sessions
    ``states`` as one program (the reference's ``_batched_select``): on the
    card a graph captured once per strategy, K, batch size, options, group
    plan and corpus, which stacks the sessions' buffers inside.  Session k
    draws from ``generators[k]`` in its own selection's order; ``params``
    is shared or (K,) (:meth:`StrategyParams.stack`)."""
    prog = cohort_program(name, batch_size, options)
    s0 = states[0]
    drawn = prog.draw(generators, s0.x.shape[0], s0.mu.dtype, s0.mu.device)
    inputs, groups = cohort_program_inputs(states)
    inputs.update(params.program_inputs(), **drawn)
    (batch,) = graphs.run(
        f"select_{name}_stacked",
        functools.partial(_stacked_body, picks=prog.picks, drawn=tuple(drawn), groups=groups),
        inputs, shared=program_shared(s0), static=(batch_size, prog.static, groups))
    return batch


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


def greedy_argmax_stacked(score_fn, st: StackedGPState, batch_size: int) -> torch.Tensor:
    """Greedy batch construction of K sessions: repeatedly take each
    session's argmax of a per-candidate score.

    ``score_fn(batch, t) -> (K, N)`` scores may depend on ``batch[:, :t]``,
    each session's picks so far; labeled and already-picked candidates are
    masked to -inf.  Ties go to the lowest index of each row, as
    ``jnp.argmax``.  Returns the (K, batch_size) picks.
    """
    excluded = labeled_mask(st)
    batch = torch.zeros((st.k, batch_size), dtype=torch.int64, device=st.idx.device)
    for t in range(batch_size):
        scores = torch.where(excluded, -torch.inf, score_fn(batch, t))
        nxt = torch.argmax(scores, dim=1)
        batch[:, t] = nxt
        excluded.scatter_(1, nxt[:, None], True)
    return batch

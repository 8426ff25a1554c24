"""Interactive retrieval session — the user-facing API (port of ``ital_tpu.models.session``).

Holds the corpus, the GP state and the labeled sets, applies feedback rounds,
ranks the corpus, and picks the next batch through the configured selection
strategy.  Everything runs on the corpus' device; only the returned batches
and rankings come to the host.

On the card every fetch, whatever the strategy, every update and every
re-learn each replay one captured program (:mod:`ital_tpu_torch.graphs`),
the counterparts of the reference's ``_jit_select``, ``_update_donated`` and
jitted ``fit_hyperparams``: process-wide, shared by every session with the
same signature.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ital_tpu_torch import graphs
from ital_tpu_torch.models import gp as gp_mod
from ital_tpu_torch.ops.chol import host_copy
from ital_tpu_torch.select.base import (
    StrategyParams,
    filter_method_kwargs,
    get_strategy,
    labeled_mask,
    validate_method_kwargs,
)
from ital_tpu_torch.utils.metrics import top_k_stable

# Feedback blocks are padded up to a multiple of this width (valid=False on
# the pad slots: mathematically absent, but they consume capacity slots like
# any skipped item), so the labeled slots line up with the reference's.
_UPDATE_BUCKET = 4


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``, ``cuda`` where it is None.

    A CUDA device without a card raises; nothing moves to the CPU unless the
    caller asks for it.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev}: no CUDA device is available (pass device='cpu' to run on the CPU)"
        )
    return dev


def feedback_block(state: gp_mod.GPState,
                   feedback: Dict[int, int]) -> tuple[np.ndarray, np.ndarray]:
    """The block a session absorbs for ``feedback``: (b,) int64 corpus
    indices and (b,) float32 labels, 0 where skipped, padded to the bucket
    width and clamped to the remaining capacity of ``state``.  Raises
    ``ValueError`` when the labels overflow the capacity."""
    used = state.count
    cap = state.cap
    if used + len(feedback) > cap:
        raise ValueError(
            f"labeled-slot capacity exceeded: {used} used + {len(feedback)} new "
            f"> cap={cap}; construct the session with a larger `cap`"
        )
    b = min(-(-len(feedback) // _UPDATE_BUCKET) * _UPDATE_BUCKET, cap - used)
    idx = np.zeros(b, dtype=np.int64)
    idx[: len(feedback)] = np.fromiter(feedback.keys(), dtype=np.int64)
    y = np.zeros(b, dtype=np.float32)
    y[: len(feedback)] = [0 if v is None else int(v) for v in feedback.values()]
    return idx, y


def _update_body(x, *, new_idx, new_y, new_valid, **inputs) -> tuple:
    gp_mod.gp_update(gp_mod.program_state(x, inputs), new_idx, new_y, new_valid)
    return ()


def update_program(state: gp_mod.GPState, new_idx: torch.Tensor, new_y: torch.Tensor,
                   new_valid: torch.Tensor) -> gp_mod.GPState:
    """:func:`ital_tpu_torch.models.gp.gp_update` of ``state`` as one
    program (the reference's ``_update_donated``): on the card a graph
    captured once per block width, capacity and corpus, into whose buffers
    the session's are copied, and from which what the update writes is
    copied back.  A block that is not positive definite raises once the
    program has run, and leaves ``state`` as it was.  ``new_*`` (b,) lie on
    the state's device."""
    gp_mod.check_capacity([state.count], new_idx.shape[0], state.cap)
    inputs = {**gp_mod.program_inputs(state), "new_idx": new_idx, "new_y": new_y,
              "new_valid": new_valid}
    graphs.run("gp_update", _update_body, inputs, shared={"x": state.x},
               writes=gp_mod.SESSION_FIELDS)
    state.count += new_idx.shape[0]
    return state


def check_method_kwargs(strategy: str, method_kwargs: dict) -> None:
    """Reject a session's options before anything is built: non-scalar
    values, unknown strategies and options ``strategy`` does not declare."""
    for name, v in method_kwargs.items():
        if isinstance(v, str) or not isinstance(v, (int, float, bool, type(None))):
            raise TypeError(
                f"method_kwargs[{name!r}] must be a numeric/bool scalar "
                f"(int/float/bool/None), got {type(v).__name__}"
            )
    get_strategy(strategy)  # fail fast on unknown strategy names
    validate_method_kwargs(strategy, method_kwargs)


class ActiveRetrieval:
    """One interactive retrieval session over a fixed corpus.

    Usage::

        sess = ActiveRetrieval(x, length_scale=2.0, var=1.0, noise=0.1, cap=64)
        sess.update_query(q)
        batch = sess.fetch_unlabelled(4)          # show these to the user
        sess.update({batch[0]: 1, batch[1]: -1})  # feedback (missing = skipped)
        ranking = sess.top_k(20)

    ``x`` is a tensor, whose device is the session's unless ``device`` is
    given, or a NumPy array, which goes to ``device`` (default ``cuda``;
    without a card that raises).  ``tradeoff`` weighs the two criteria of the
    density/diversity baselines; ``with_density`` attaches the corpus
    density (:func:`ital_tpu_torch.models.gp.corpus_density`) they read.
    """

    def __init__(
        self,
        x,
        *,
        length_scale: float,
        var: float = 1.0,
        noise: float = 0.1,
        cap: int = 64,
        strategy: str = "ital",
        label_prob: float = 1.0,
        mistake_prob: float = 0.0,
        tradeoff: float = 0.5,
        with_density: bool = False,
        seed: int = 0,
        method_kwargs: Optional[dict] = None,
        corpus_dtype: Optional[str] = None,
        device=None,
    ):
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x), device=resolve_device(device))
        elif device is not None:
            x = x.to(resolve_device(device))
        self.device = x.device
        self.state = gp_mod.gp_init(x, length_scale, var, noise, cap,
                                    corpus_dtype=corpus_dtype or None)
        if with_density:
            self.state.density = gp_mod.corpus_density(self.state)
        self.strategy_name = strategy
        self.method_kwargs = dict(method_kwargs or {})
        check_method_kwargs(strategy, self.method_kwargs)
        self.params = StrategyParams.create(
            self.device, label_prob=label_prob, mistake_prob=mistake_prob,
            tradeoff=tradeoff,
        )
        # The same values on the host: sessions whose keys are equal share
        # one StrategyParams in a stacked selection.
        self.params_key = (float(label_prob), float(mistake_prob), float(tradeoff))
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.query: Optional[int] = None

    def update_query(self, query_idx: int) -> None:
        """Reset the session to a new query image (counted as a +1 label)."""
        self.query = int(query_idx)
        self.state = gp_mod.gp_set_query(self.state, self.query)

    def fetch_unlabelled(self, k: int) -> np.ndarray:
        """Next batch of k candidate indices to show the user: the
        strategy's selection program (the reference's ``_jit_select``), its
        draws from the session's generator."""
        select = get_strategy(self.strategy_name)
        # Filtered on every call: a restored session's options replace
        # method_kwargs, and may name options another strategy declares.
        kw = filter_method_kwargs(self.strategy_name, self.method_kwargs)
        batch = select(self.state, int(k), self.generator, self.params, **kw)
        return batch.cpu().numpy()

    def update(self, feedback: Dict[int, int]) -> None:
        """Apply one round of user feedback and refresh the posterior.

        ``feedback``: corpus index -> label in {-1, +1}; items mapped to 0 or
        None are treated as skipped.
        """
        if not feedback:
            return
        idx, y = self.feedback_block(feedback)
        dev = self.device
        self.state = update_program(self.state, host_copy(idx, dev), host_copy(y, dev),
                                    host_copy(y != 0, dev))

    def feedback_block(self, feedback: Dict[int, int]) -> tuple[np.ndarray, np.ndarray]:
        """The block :meth:`update` absorbs for ``feedback``
        (:func:`feedback_block`)."""
        return feedback_block(self.state, feedback)

    def scores(self) -> np.ndarray:
        """Relevance scores (GP posterior mean) for the whole corpus (a copy)."""
        return self.state.mu.cpu().numpy().copy()

    def top_k(self, k: int, exclude_labeled: bool = True) -> np.ndarray:
        """Top-k retrieval by posterior mean; ties go to the lower index."""
        scores = self.state.mu
        if exclude_labeled:
            scores = torch.where(labeled_mask(self.state), -torch.inf, scores)
        return top_k_stable(scores, k)[1].cpu().numpy()

    @property
    def relevant_ids(self) -> np.ndarray:
        """Indices the user has labeled relevant."""
        st = self.state
        keep = st.active & (st.y > 0)
        return st.idx[keep].cpu().numpy()

    @property
    def irrelevant_ids(self) -> np.ndarray:
        st = self.state
        keep = st.active & (st.y < 0)
        return st.idx[keep].cpu().numpy()

    def learn_hyperparams(
        self,
        *,
        steps: int = 50,
        lr: float = 0.05,
        learn_noise: bool = True,
        prior_strength: float = 0.0,
        noise_floor: float = 0.0,
    ) -> Dict[str, float]:
        """Re-learn the GP hyperparameters from this session's labels and refit.

        Type-II maximum likelihood (:mod:`ital_tpu_torch.models.hyperopt`), or
        MAP type-II with ``prior_strength``/``noise_floor``, anchored at the
        current hyperparameters; the ascent and the refit are one program
        (:func:`~ital_tpu_torch.models.hyperopt.relearn`).  Returns the new
        values.  Should the fit or the refit raise (a labeled block that is
        not positive definite), the session keeps its state as it was.
        """
        from ital_tpu_torch.models.hyperopt import relearn

        hyper = relearn(self.state, steps=steps, lr=lr, learn_noise=learn_noise,
                        prior_strength=prior_strength, noise_floor=noise_floor)
        return {
            "length_scale": float(hyper.length_scale),
            "var": float(hyper.var),
            "noise": float(hyper.noise),
        }

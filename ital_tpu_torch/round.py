"""One full feedback round on the port: select, simulated user, update, AP.

The PyTorch counterpart of the reference's single-chip round step
(``__graft_entry__.py::entry``'s ``round_step``): ITAL batch selection,
the simulated noisy user, the incremental GP update and the AP of the new
ranking, as one program (:func:`ital_tpu_torch.graphs.run`; on the card a
captured graph, as the reference jits its round step).
"""

from __future__ import annotations

from typing import Optional

import torch

from ital_tpu_torch import graphs
from ital_tpu_torch.data.user import feedback_from_uniforms
from ital_tpu_torch.models.gp import (
    SESSION_FIELDS,
    GPState,
    check_capacity,
    gp_update,
    program_inputs,
    program_state,
)
from ital_tpu_torch.select.base import StrategyParams
from ital_tpu_torch.select.ital import select_ital
from ital_tpu_torch.utils.metrics import average_precision

BATCH_SIZE = 4
N_QMC = 64


def _round_body(x, *, u_label, u_flip, relevant, exclude, **inputs) -> tuple:
    """The round as a program's body: the selection, the user's answers
    from the fed uniforms, the update of the state (in place) and the AP."""
    state, params = program_state(x, inputs), StrategyParams.from_inputs(inputs)
    batch = select_ital(state, BATCH_SIZE, None, params, n_qmc=N_QMC)
    y, valid = feedback_from_uniforms(u_label, u_flip, batch, relevant,
                                      params.label_prob, params.mistake_prob)
    state = gp_update(state, batch, y, valid)
    return batch, average_precision(state.mu, relevant, exclude)


def round_step(
    state: GPState,
    generator: torch.Generator,
    relevant: torch.Tensor,
    exclude: torch.Tensor,
    params: StrategyParams,
    *,
    user_uniforms: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
) -> tuple[GPState, torch.Tensor, torch.Tensor]:
    """Run one round; returns ``(state, batch, ap)``.

    ``state`` is updated in place.  ``generator`` (on the state's device)
    draws the user's answers, two (BATCH_SIZE,) uniform vectors drawn before
    the round runs, unless ``user_uniforms`` gives them; ``relevant`` and
    ``exclude`` are (N,) bool.
    """
    check_capacity([state.count], BATCH_SIZE, state.cap)
    if user_uniforms is None:
        dev = state.mu.device
        user_uniforms = (torch.rand(BATCH_SIZE, generator=generator, device=dev),
                         torch.rand(BATCH_SIZE, generator=generator, device=dev))
    u_label, u_flip = user_uniforms
    inputs = {**program_inputs(state), **params.program_inputs(), "u_label": u_label,
              "u_flip": u_flip, "relevant": relevant, "exclude": exclude}
    batch, ap = graphs.run("round_step", _round_body, inputs, shared={"x": state.x},
                           writes=SESSION_FIELDS)
    state.count += BATCH_SIZE
    return state, batch, ap

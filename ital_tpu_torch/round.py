"""One full feedback round on the port: select, simulated user, update, AP.

The PyTorch counterpart of the reference's single-chip round step
(``__graft_entry__.py::entry``'s ``round_step``): ITAL batch selection,
the simulated noisy user, the incremental GP update and the AP of the new
ranking.
"""

from __future__ import annotations

import torch

from ital_tpu_torch.data.user import simulate_feedback
from ital_tpu_torch.models.gp import GPState, gp_update
from ital_tpu_torch.select.base import StrategyParams
from ital_tpu_torch.select.ital import select_ital
from ital_tpu_torch.utils.metrics import average_precision

BATCH_SIZE = 4
N_QMC = 64


def round_step(
    state: GPState,
    generator: torch.Generator,
    relevant: torch.Tensor,
    exclude: torch.Tensor,
    params: StrategyParams,
) -> tuple[GPState, torch.Tensor, torch.Tensor]:
    """Run one round; returns ``(state, batch, ap)``.

    ``state`` is updated in place.  ``generator`` (on the state's device)
    draws the user's answers; ``relevant`` and ``exclude`` are (N,) bool.
    """
    batch = select_ital(state, BATCH_SIZE, generator, params, n_qmc=N_QMC)
    y, valid = simulate_feedback(generator, batch, relevant,
                                 params.label_prob, params.mistake_prob)
    state = gp_update(state, batch, y, valid)
    return state, batch, average_precision(state.mu, relevant, exclude)

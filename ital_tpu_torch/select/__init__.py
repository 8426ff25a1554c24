"""Selection strategies: ITAL mutual-information batch selection."""

from ital_tpu_torch.select.base import STRATEGIES, get_strategy, register  # noqa: F401

# Import for registration side effects.
from ital_tpu_torch.select import ital as _ital  # noqa: F401,E402

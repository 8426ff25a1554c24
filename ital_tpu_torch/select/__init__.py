"""Selection strategies: ITAL, the 15 baselines and the regression variant."""

from ital_tpu_torch.select.base import STRATEGIES, get_strategy, register  # noqa: F401

# Import for registration side effects.
from ital_tpu_torch.select import ital as _ital  # noqa: F401,E402
from ital_tpu_torch.select import baselines as _baselines  # noqa: F401,E402
from ital_tpu_torch.select import regression as _regression  # noqa: F401,E402

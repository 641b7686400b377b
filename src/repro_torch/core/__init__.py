"""CAFL-L core in PyTorch: duals, policy, resource proxies, token-budget
preservation, compression, freezing, client and server pieces."""
from repro_torch.core.duals import (  # noqa: F401
    RESOURCES, DualState, deadzone, dual_update, lagrangian_value,
    usage_ratios,
)
from repro_torch.core.policy import (  # noqa: F401
    Knobs, fedavg_knobs, policy, token_budget_accum,
)
from repro_torch.core.resources import (  # noqa: F401
    BYTES_PER_PARAM, TABLE1_FEDAVG, ResourceModel, calibrate,
)
from repro_torch.core import aggregation  # noqa: F401
from repro_torch.core.client import ClientResult, ClientRunner  # noqa: F401
from repro_torch.core.server import (  # noqa: F401
    FLResult, RoundRecord, make_eval_fn, run_federated,
)

"""The constraint stack in PyTorch's port: constraints x dual controllers
x knob policies, at the paper's defaults (the four proxies, the dead-zone
subgradient, the Eq. 5-7 mapping)."""
from repro_torch.constraints.constraint import (  # noqa: F401
    CONSTRAINT_REGISTRY, KNOB_GROUPS, Constraint, ConstraintReport,
    ConstraintSet, make_constraints, paper_constraints, register_constraint,
)
from repro_torch.constraints.controllers import (  # noqa: F401
    DeadzoneSubgradient, DualController, make_controller,
)
from repro_torch.constraints.knobs import (  # noqa: F401
    KnobPolicy, PaperKnobPolicy, make_knob_policy,
)

"""The constraint stack of the port: pluggable constraints x dual
controllers x knob policies (the Lagrangian loop of Eq. 2-7), and the
proxy-only loop simulation.

    from repro_torch.constraints import (make_constraints, PIController,
                                         DeadlineAwareKnobPolicy)

    strategy = CAFLL(fl, constraints="paper+wire_mb",
                     controller=PIController(),
                     knob_policy=DeadlineAwareKnobPolicy())
"""
from repro_torch.constraints.constraint import (  # noqa: F401
    CONSTRAINT_REGISTRY, KNOB_GROUPS, Constraint, ConstraintReport,
    ConstraintSet, make_constraints, paper_constraints, register_constraint,
)
from repro_torch.constraints.controllers import (  # noqa: F401
    CONTROLLERS, AdaptiveStep, DeadzoneSubgradient, DualController,
    PIController, dual_config_for, make_controller, resolve_dual_configs,
)
from repro_torch.constraints.knobs import (  # noqa: F401
    KNOB_POLICIES, DeadlineAwareKnobPolicy, KnobPolicy, PaperKnobPolicy,
    make_knob_policy,
)
from repro_torch.constraints.sim import (  # noqa: F401
    proxy_control_loop, rounds_to_band, tail_worst_ratio,
)

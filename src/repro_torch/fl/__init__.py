"""The federated engine of the port: Strategy x Executor x DeviceProfile
x FleetDynamics x Aggregator x Callback, on one device.

    from repro_torch.fl import FederatedEngine, LoggingCallback

    engine = FederatedEngine(model, fl, dataset, strategy="cafl",
                             executor="batched",
                             aggregator="fedbuff",   # default: "sync"
                             callbacks=[LoggingCallback()])
    result = engine.run()          # on the card; device="cpu" for the CPU
"""
from repro_torch.constraints import (  # noqa: F401
    AdaptiveStep, Constraint, ConstraintReport, ConstraintSet,
    DeadlineAwareKnobPolicy, DeadzoneSubgradient, DualController,
    KnobPolicy, PIController, PaperKnobPolicy, make_constraints,
    make_controller, make_knob_policy, paper_constraints,
    register_constraint,
)
from repro_torch.core.client import ClientResult, ClientRunner  # noqa: F401
from repro_torch.core.server import FLResult, RoundRecord  # noqa: F401
from repro_torch.fl.aggregator import (  # noqa: F401
    Aggregator, ClientReport, ConstantStaleness, FedBuffAggregator,
    MaskedSumAggregator, PolynomialStaleness, ServerUpdate,
    StalenessPolicy, StalenessWeightedAggregator, SyncAggregator,
    canonical_order, make_aggregator, make_staleness_policy,
    report_order_key,
)
from repro_torch.fl.callbacks import (  # noqa: F401
    CheckpointCallback, HistoryWriterCallback, LoggingCallback,
    RoundCallback, TimingCallback,
)
from repro_torch.fl.clock import (  # noqa: F401
    TIME_MODES, EventQueue, KnobRoundTime, RoundTimeModel, SimClock,
    TimedReport, make_round_time, seconds_to_target,
)
from repro_torch.fl.device import (  # noqa: F401
    DEFAULT_PROFILE, ClientInfo, DeviceProfile, FleetClass, make_fleet,
    uniform_fleet,
)
from repro_torch.fl.dynamics import (  # noqa: F401
    AlwaysAvailable, AvailabilityModel, BernoulliChurn, ClientSampler,
    DeadlineStragglers, FleetDynamics, FullParticipation, NoStragglers,
    PeriodicAvailability, ResourceAwareSampler, RoundPlan,
    RoundRobinSampler, StragglerModel, UniformSampler, make_dynamics,
)
from repro_torch.fl.engine import FederatedEngine  # noqa: F401
from repro_torch.fl.executor import (  # noqa: F401
    BatchedExecutor, ClientExecutor, SequentialExecutor, make_executor,
)
from repro_torch.fl.strategy import (  # noqa: F401
    CAFLL, FedAvg, FederatedStrategy, ServerOpt, make_strategy,
)

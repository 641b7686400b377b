"""The federated engine of the port: Strategy x Executor x DeviceProfile
x FleetDynamics x Aggregator x Callback, on one device.

    from repro_torch.fl import FederatedEngine, LoggingCallback

    engine = FederatedEngine(model, fl, dataset, strategy="cafl",
                             aggregator="masked",   # default: "sync"
                             callbacks=[LoggingCallback()])
    result = engine.run()          # on the card; device="cpu" for the CPU
"""
from repro_torch.constraints import (  # noqa: F401
    Constraint, ConstraintReport, ConstraintSet, DeadzoneSubgradient,
    DualController, KnobPolicy, PaperKnobPolicy, make_constraints,
    make_controller, make_knob_policy, paper_constraints, register_constraint,
)
from repro_torch.core.client import ClientResult, ClientRunner  # noqa: F401
from repro_torch.core.server import FLResult, RoundRecord  # noqa: F401
from repro_torch.fl.aggregator import (  # noqa: F401
    Aggregator, ClientReport, MaskedSumAggregator, ServerUpdate,
    SyncAggregator, canonical_order, make_aggregator, report_order_key,
)
from repro_torch.fl.callbacks import (  # noqa: F401
    CheckpointCallback, HistoryWriterCallback, LoggingCallback,
    RoundCallback, TimingCallback,
)
from repro_torch.fl.clock import (  # noqa: F401
    KnobRoundTime, RoundTimeModel, SimClock, make_round_time,
)
from repro_torch.fl.device import (  # noqa: F401
    DEFAULT_PROFILE, ClientInfo, DeviceProfile, uniform_fleet,
)
from repro_torch.fl.dynamics import (  # noqa: F401
    AlwaysAvailable, AvailabilityModel, ClientSampler, FleetDynamics,
    NoStragglers, RoundPlan, StragglerModel, UniformSampler, make_dynamics,
)
from repro_torch.fl.engine import FederatedEngine  # noqa: F401
from repro_torch.fl.executor import (  # noqa: F401
    ClientExecutor, SequentialExecutor, make_executor,
)
from repro_torch.fl.strategy import (  # noqa: F401
    CAFLL, FedAvg, FederatedStrategy, make_strategy,
)

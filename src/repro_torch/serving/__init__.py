from repro_torch.serving.cluster import (  # noqa: F401
    ClusterEngine,
    HandoverEvent,
    cluster_from_scenario,
    serve_fleet,
)
from repro_torch.serving.engine import (  # noqa: F401
    EngineConfig,
    NodeExecutor,
    NodeSpec,
    RecoveryConfig,
    Request,
    ServingEngine,
    apply_block_results,
)
from repro_torch.serving.gdm_service import (  # noqa: F401
    GDMService,
    SlotBatch,
    make_gdm_services,
)
from repro_torch.serving.kv_manager import TransferLedger, state_nbytes  # noqa: F401
from repro_torch.serving.policy_bridge import (  # noqa: F401
    ServingPolicy,
    engine_from_scenario,
    serve_trace,
    submit_arrivals,
)
from repro_torch.serving.scheduler import (  # noqa: F401
    SchedulerConfig,
    attach_scheduler,
    continuous_step,
    serve_fleet_continuous,
)
from repro_torch.serving.telemetry import QuantumEvent, TelemetryLog  # noqa: F401
from repro_torch.serving.tracing import MetricsRegistry, Tracer  # noqa: F401

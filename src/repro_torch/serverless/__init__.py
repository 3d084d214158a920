"""The port's serverless layer: the platform and backends, the analytic
worker model, the discrete-event engine, the arrival processes, the
simulated stores and the semantic ``LocalWorkerPool``."""
from repro_torch.serverless.arrivals import (  # noqa: F401
    ArrivalSpec, RequestStream, ServingTask)
from repro_torch.serverless.backends import (  # noqa: F401
    BACKENDS, BackendSpec, PriceTrace, hazard_cadence_s, resolve_backend,
    simulate_spot_epoch, spot_variant)
from repro_torch.serverless.events import (  # noqa: F401
    ContentionDomain, EngineResult, EventEngine, ServingJob, ServingResult)
from repro_torch.serverless.platform import (  # noqa: F401
    BillingLedger, FleetSpec, ServerlessPlatform, ShockModel, WorkerSpec,
    fleet_from_config)
from repro_torch.serverless.stores import ObjectStore, ParamStore, SharedLink  # noqa: F401
from repro_torch.serverless.worker import (  # noqa: F401
    WORKLOADS, LocalWorkerPool, Workload, comm_breakdown, iteration_time,
    parse_sync_mode)

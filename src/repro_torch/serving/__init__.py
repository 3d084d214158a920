from repro_torch.serving.batcher import (  # noqa: F401
    BatchRecord, ServePolicy, ServeStats, exec_time, optimize_policy,
    simulate)
from repro_torch.serving.engine import Completion, Request, ServingEngine  # noqa: F401

"""The port's serverless layer: the simulated stores and the semantic
``LocalWorkerPool``."""
from repro_torch.serverless.stores import ObjectStore, ParamStore, SharedLink  # noqa: F401
from repro_torch.serverless.worker import LocalWorkerPool, parse_sync_mode  # noqa: F401

from repro_torch.serving.engine import Completion, Request, ServingEngine  # noqa: F401

from repro_torch.optim.adamw import AdamW, AdamWState, apply_sgd  # noqa: F401
from repro_torch.optim.schedules import (  # noqa: F401
    constant, doubling_batch, fixed_batch, step_batch, warmup_cosine)

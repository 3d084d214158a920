from repro_torch.distributed.sharding import (  # noqa: F401
    batch_specs, cache_specs, gather_model_part, model_part, opt_state_specs,
    param_specs, placement)

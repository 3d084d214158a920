from repro_torch.data.pipeline import (  # noqa: F401
    DataConfig, IteratorState, OnlineStream, ShardedLoader, TokenDataset)

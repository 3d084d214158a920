from repro_torch.models.base import INPUT_SHAPES, InputShape, ModelConfig  # noqa: F401

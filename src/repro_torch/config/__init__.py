from repro_torch.config.base import (
    LayerDesc,
    LayerLayout,
    MoEConfig,
    MambaConfig,
    MLAConfig,
    EncoderConfig,
    MemComConfig,
    ModelConfig,
    ShapeSpec,
    SHAPES,
)

__all__ = [
    "LayerDesc",
    "LayerLayout",
    "MoEConfig",
    "MambaConfig",
    "MLAConfig",
    "EncoderConfig",
    "MemComConfig",
    "ModelConfig",
    "ShapeSpec",
    "SHAPES",
]

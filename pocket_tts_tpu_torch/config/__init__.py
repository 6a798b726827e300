from pocket_tts_tpu_torch.config.schema import (
    Config,
    FlowConfig,
    FlowLMConfig,
    FlowLMTransformerConfig,
    LookupTable,
    MimiConfig,
    MimiTransformerConfig,
    QuantizerConfig,
    SEANetConfig,
    load_config,
)

__all__ = [
    "Config",
    "FlowConfig",
    "FlowLMConfig",
    "FlowLMTransformerConfig",
    "LookupTable",
    "MimiConfig",
    "MimiTransformerConfig",
    "QuantizerConfig",
    "SEANetConfig",
    "load_config",
]

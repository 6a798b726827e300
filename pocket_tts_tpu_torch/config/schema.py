"""Typed YAML model configuration.

Schema-compatible with the reference config format
(reference: pocket_tts_mlx/utils/config.py:9-128 and
pocket_tts_mlx/config/b6369a24.yaml) so the same YAML files load unchanged.
"""

from __future__ import annotations

from pathlib import Path

import yaml
from pydantic import BaseModel, ConfigDict


class StrictModel(BaseModel):
    """Base model that rejects unknown fields, catching config typos early."""

    model_config = ConfigDict(extra="forbid")


class FlowConfig(StrictModel):
    """Flow-matching MLP head: number of AdaLN residual blocks and width."""

    dim: int
    depth: int


class FlowLMTransformerConfig(StrictModel):
    """FlowLM backbone transformer hyperparameters."""

    hidden_scale: int
    max_period: int
    d_model: int
    num_heads: int
    num_layers: int


class LookupTable(StrictModel):
    """Text tokenizer + embedding table parameters."""

    dim: int
    n_bins: int
    tokenizer: str
    tokenizer_path: str


class FlowLMConfig(StrictModel):
    """FlowLM model configuration."""

    dtype: str
    flow: FlowConfig
    transformer: FlowLMTransformerConfig
    lookup_table: LookupTable
    weights_path: str | None = None


class SEANetConfig(StrictModel):
    """SEANet convolutional encoder/decoder hyperparameters."""

    dimension: int
    channels: int
    n_filters: int
    n_residual_layers: int
    ratios: list[int]
    kernel_size: int
    residual_kernel_size: int
    last_kernel_size: int
    dilation_base: int
    pad_mode: str
    compress: int


class MimiTransformerConfig(StrictModel):
    """Mimi codec transformer hyperparameters (fixed attention window)."""

    d_model: int
    input_dimension: int
    output_dimensions: tuple[int, ...]
    num_heads: int
    num_layers: int
    layer_scale: float
    context: int
    max_period: float = 10000.0
    dim_feedforward: int


class QuantizerConfig(StrictModel):
    """Latent projection dims (the stripped-VQ 'dummy quantizer')."""

    dimension: int
    output_dimension: int


class MimiConfig(StrictModel):
    """Mimi codec configuration."""

    dtype: str
    sample_rate: int
    channels: int
    frame_rate: float
    seanet: SEANetConfig
    transformer: MimiTransformerConfig
    quantizer: QuantizerConfig
    weights_path: str | None = None


class Config(StrictModel):
    """Top-level model configuration: FlowLM + Mimi + shared checkpoint."""

    flow_lm: FlowLMConfig
    mimi: MimiConfig
    weights_path: str | None = None
    weights_path_without_voice_cloning: str | None = None


def load_config(yaml_path: str | Path) -> Config:
    """Load a YAML model config into a validated Config object."""
    yaml_path = Path(yaml_path)
    if not yaml_path.exists():
        raise FileNotFoundError(f"Config file not found: {yaml_path}")
    with open(yaml_path, "r") as f:
        raw = yaml.safe_load(f)
    return Config(**raw)


def builtin_config_path(variant: str) -> Path:
    """Path to a packaged model-variant YAML (e.g. 'b6369a24')."""
    return Path(__file__).parent / f"{variant}.yaml"

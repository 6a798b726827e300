"""Asset resolution for the PyTorch port: local files only.

Configs name remote assets as `hf://repo/file@revision` or http(s) URLs
(the reference URI scheme, pocket_tts_mlx/utils/utils.py:56-84). The port
fetches nothing over the network: a remote URI raises ConnectionError, which
the loaders treat like the reference treats an unreachable asset (fall back
to random weights, the hash tokenizer and the synthetic voice prompt). Point
a config's `weights_path` at a local safetensors file to load real weights.
"""

from __future__ import annotations

from pathlib import Path


def download_if_necessary(file_path: str) -> Path:
    """Resolve an asset URI to a local file; remote URIs are refused."""
    if file_path.startswith(("http://", "https://", "hf://")):
        raise ConnectionError(f"the PyTorch port fetches no remote assets: {file_path}")
    local = Path(file_path)
    if not local.exists():
        raise FileNotFoundError(f"asset not found: {file_path}")
    return local

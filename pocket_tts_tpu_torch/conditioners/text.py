"""Lookup-table text conditioner: text -> tokens -> embedding rows
(port of pocket_tts_tpu/conditioners/text.py; reference:
pocket_tts_mlx/conditioners/text.py:15-45)."""

from __future__ import annotations

import torch

from pocket_tts_tpu_torch.models.text import TokenizedText, make_tokenizer


class LUTConditioner:
    """`prepare` tokenizes ([1, T] int32); calling embeds with the bound
    [n_bins + 1, dim] table."""

    def __init__(self, n_bins: int, tokenizer_path: str, dim: int,
                 embed_weight: torch.Tensor | None = None, tokenizer=None):
        self.dim = dim
        self.tokenizer = tokenizer if tokenizer is not None else make_tokenizer(n_bins, tokenizer_path)
        self.embed_weight = embed_weight

    def prepare(self, text: str) -> TokenizedText:
        return self.tokenizer(text)

    def __call__(self, inputs: TokenizedText) -> torch.Tensor:
        if self.embed_weight is None:
            raise ValueError("bind embed_weight before use")
        tokens = torch.as_tensor(inputs.tokens, dtype=torch.long, device=self.embed_weight.device)
        return self.embed_weight[tokens]

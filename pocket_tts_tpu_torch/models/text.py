"""Text tokenization, normalization and sentence-aware chunking.

Normalization and chunk-packing semantics mirror the reference exactly
(reference: pocket_tts_mlx/models/tts_model.py:521-593), since they shape the
token stream the checkpoint was trained on.

Tokenizers: the real model uses SentencePiece; because `sentencepiece` is an
optional dependency here, a deterministic hash-based fallback tokenizer keeps
the full pipeline runnable (tests, benchmarks, air-gapped machines). The
fallback is NOT vocabulary-compatible with the checkpoint — it exists so the
framework never hard-fails on an import.
"""

from __future__ import annotations

import hashlib
import logging
import math
import re
from typing import NamedTuple, Protocol

import numpy as np

logger = logging.getLogger(__name__)


class TokenizedText(NamedTuple):
    """Token container ([1, T] int32), reference: conditioners/base.py:12-15."""

    tokens: np.ndarray


class Tokenizer(Protocol):
    def encode(self, text: str) -> list[int]: ...
    def decode(self, tokens: list[int]) -> str: ...
    def end_of_sentence_tokens(self) -> set[int]: ...
    def __call__(self, text: str) -> TokenizedText: ...


class SentencePieceTokenizer:
    """SentencePiece tokenizer (vocab must match the config's n_bins;
    reference: pocket_tts_mlx/conditioners/text.py:15-29).

    Prefers the native `sentencepiece` package; without it, the pure-Python
    unigram engine (utils/spm.py) loads the same `.model` file, so the real
    vocabulary works on air-gapped machines too."""

    def __init__(self, n_bins: int, tokenizer_path: str):
        from pocket_tts_tpu_torch.utils.assets import download_if_necessary

        logger.info("Loading SentencePiece tokenizer from %s", tokenizer_path)
        local = download_if_necessary(tokenizer_path)
        try:
            import sentencepiece

            self.sp = sentencepiece.SentencePieceProcessor(str(local))
        except ImportError:
            from pocket_tts_tpu_torch.utils.spm import SentencePieceProcessor

            logger.info(
                "`sentencepiece` not installed; using the pure-Python "
                "unigram engine (pocket_tts_tpu_torch.utils.spm)"
            )
            self.sp = SentencePieceProcessor(str(local))
        assert n_bins == self.sp.vocab_size(), (
            f"sentencepiece tokenizer has vocab_size={self.sp.vocab_size()} "
            f"but n_bins={n_bins} was specified"
        )

    def encode(self, text: str) -> list[int]:
        return self.sp.encode(text, out_type=int)

    def decode(self, tokens: list[int]) -> str:
        return self.sp.decode(tokens)

    def end_of_sentence_tokens(self) -> set[int]:
        # Drop the leading whitespace-marker token, keep the punctuation ids
        # (reference: tts_model.py:527).
        return set(self.encode(".!...?")[1:])

    def __call__(self, text: str) -> TokenizedText:
        return TokenizedText(np.asarray(self.encode(text), dtype=np.int32)[None, :])


_EOS_RESERVED = 64  # fallback ids below this mark end-of-sentence punctuation


class FallbackWordTokenizer:
    """Deterministic hash tokenizer used when sentencepiece is unavailable.

    Splits text into punctuation runs and whitespace-prefixed words; ids are
    stable hashes into [0, n_bins). Decoding uses a session-local reverse map,
    which is sufficient for sentence chunking (only just-encoded ids are ever
    decoded).
    """

    def __init__(self, n_bins: int = 4000):
        self.n_bins = n_bins
        self._id_to_piece: dict[int, str] = {}

    def _piece_id(self, piece: str) -> int:
        h = int.from_bytes(hashlib.md5(piece.encode()).digest()[:4], "little")
        if re.fullmatch(r"[.!?]+", piece):
            token = h % _EOS_RESERVED
        else:
            token = _EOS_RESERVED + h % (self.n_bins - _EOS_RESERVED)
        self._id_to_piece[token] = piece
        return token

    def encode(self, text: str) -> list[int]:
        pieces = re.findall(r"[.!?]+|\s*[^\s.!?]+", text)
        return [self._piece_id(p) for p in pieces]

    def decode(self, tokens: list[int]) -> str:
        return "".join(self._id_to_piece.get(t, "") for t in tokens)

    def end_of_sentence_tokens(self) -> set[int]:
        return set(range(_EOS_RESERVED))

    def __call__(self, text: str) -> TokenizedText:
        return TokenizedText(np.asarray(self.encode(text), dtype=np.int32)[None, :])


def make_tokenizer(n_bins: int, tokenizer_path: str) -> Tokenizer:
    """Build the SentencePiece tokenizer, falling back to the hash tokenizer
    when the dependency or the asset is unavailable."""
    try:
        return SentencePieceTokenizer(n_bins, tokenizer_path)
    except Exception as exc:  # noqa: BLE001 — any failure degrades gracefully
        logger.warning(
            "SentencePiece tokenizer unavailable (%s); using the fallback "
            "hash tokenizer. Output will not match the published checkpoint's "
            "vocabulary.",
            exc,
        )
        return FallbackWordTokenizer(n_bins)


def prepare_text_prompt(text: str) -> tuple[str, int]:
    """Normalize a prompt and guess frames_after_eos
    (reference: pocket_tts_mlx/models/tts_model.py:572-593)."""
    text = text.strip()
    if text == "":
        raise ValueError("Text prompt cannot be empty")
    text = text.replace("\n", " ").replace("\r", " ").replace("  ", " ")
    number_of_words = len(text.split())

    frames_after_eos_guess = 3 if number_of_words <= 4 else 1

    if not text[0].isupper():
        text = text[0].upper() + text[1:]
    if text[-1].isalnum():
        text = text + "."
    if len(text.split()) < 5:
        text = " " * 8 + text
    return text, frames_after_eos_guess


def split_into_best_sentences(tokenizer: Tokenizer, text_to_generate: str, max_tokens: int) -> list[str]:
    """Split text into sentence-packed chunks of at most max_tokens tokens
    (reference: pocket_tts_mlx/models/tts_model.py:521-569)."""
    text_to_generate, _ = prepare_text_prompt(text_to_generate)
    text_to_generate = text_to_generate.strip()
    tokens = tokenizer.encode(text_to_generate)
    eos_tokens = tokenizer.end_of_sentence_tokens()

    # Sentence boundaries: position after each maximal run of EOS tokens.
    boundaries = [0]
    previous_was_eos = False
    for idx, token in enumerate(tokens):
        if token in eos_tokens:
            previous_was_eos = True
        else:
            if previous_was_eos:
                boundaries.append(idx)
            previous_was_eos = False
    boundaries.append(len(tokens))

    sentences: list[tuple[int, str]] = []
    for start, end in zip(boundaries[:-1], boundaries[1:]):
        sentences.append((end - start, tokenizer.decode(tokens[start:end])))

    chunks: list[str] = []
    current_chunk = ""
    current_tokens = 0
    for nb_tokens, sentence in sentences:
        if current_chunk == "":
            current_chunk = sentence
            current_tokens = nb_tokens
            continue
        if current_tokens + nb_tokens > max_tokens:
            chunks.append(current_chunk.strip())
            current_chunk = sentence
            current_tokens = nb_tokens
        else:
            current_chunk += " " + sentence
            current_tokens += nb_tokens
    if current_chunk != "":
        chunks.append(current_chunk.strip())
    return chunks


def estimate_max_gen_len(
    token_count: int,
    frame_rate: float,
    tokens_per_second: float = 3.0,
    padding_seconds: float = 2.0,
) -> int:
    """Upper bound on generated frames for a chunk
    (reference: pocket_tts_mlx/models/tts_model.py:440-444)."""
    gen_len_sec = token_count / tokens_per_second + padding_seconds
    return math.ceil(gen_len_sec * frame_rate)

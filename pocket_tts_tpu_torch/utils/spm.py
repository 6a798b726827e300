"""Pure-Python SentencePiece inference: parse `.model` protos + unigram encode.

The published checkpoint ships a SentencePiece `tokenizer.model`
(reference: pocket_tts_mlx/conditioners/text.py:15-29 loads it via the
`sentencepiece` package). That package is an optional native dependency; this
module makes the real tokenizer path work without it by implementing the two
pieces inference actually needs:

  1. a minimal protobuf wire-format reader for `ModelProto`
     (pieces / scores / types, trainer + normalizer specs), and
  2. the unigram-LM Viterbi segmentation over the piece vocabulary.

Scope and fidelity:
  - unigram models only (the SentencePiece default, and what TTS checkpoints
    ship); BPE models raise.
  - normalization implements the full chain: the model's embedded
    `precompiled_charsmap` (a darts-clone double-array trie over UTF-8
    prefixes -> replacement strings; this is how sentencepiece ships NFKC) is
    applied exactly when present, then add_dummy_prefix /
    remove_extra_whitespaces / escape_whitespaces. Models WITHOUT an embedded
    charsmap but named `nfkc`/`nmt_nfkc`(`_cf`) fall back to
    `unicodedata.normalize("NFKC")` plus the NMT whitespace/control rules —
    approximate only for exotic control sequences. When the `sentencepiece`
    package is installed it is preferred (models/text.py tries it first).
  - byte fallback pieces (type BYTE) are used for characters outside the
    vocabulary when present, matching `byte_fallback=true` models.

A writer (`build_model_proto`) is included so tests can vendor a tiny
trained-looking model file without the native library.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field


# SentencePiece.Type enum values (sentencepiece_model.proto)
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6

_WHITESPACE_PIECE = "▁"  # '▁'


# --------------------------------------------------------------------- proto

def _read_varint(data: bytes, i: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = data[i]
        result |= (b & 0x7F) << shift
        i += 1
        if not b & 0x80:
            return result, i
        shift += 7


def _iter_fields(data: bytes):
    """Yield (field_number, wire_type, value) over a protobuf message body.
    value is int for varint, bytes for length-delimited, raw 4/8 bytes for
    fixed32/fixed64."""
    i = 0
    n = len(data)
    while i < n:
        key, i = _read_varint(data, i)
        fnum, wtype = key >> 3, key & 7
        if wtype == 0:  # varint
            val, i = _read_varint(data, i)
        elif wtype == 1:  # fixed64
            val, i = data[i : i + 8], i + 8
        elif wtype == 2:  # length-delimited
            ln, i = _read_varint(data, i)
            val, i = data[i : i + ln], i + ln
        elif wtype == 5:  # fixed32
            val, i = data[i : i + 4], i + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wtype}")
        yield fnum, wtype, val


def _write_varint(out: bytearray, value: int) -> None:
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _write_field(out: bytearray, fnum: int, wtype: int, payload) -> None:
    _write_varint(out, (fnum << 3) | wtype)
    if wtype == 0:
        _write_varint(out, payload)
    elif wtype == 5:
        out.extend(payload)
    elif wtype == 2:
        _write_varint(out, len(payload))
        out.extend(payload)
    else:
        raise ValueError(wtype)


@dataclass
class ModelProto:
    """The subset of sentencepiece_model.proto that inference needs."""

    pieces: list[str] = field(default_factory=list)
    scores: list[float] = field(default_factory=list)
    types: list[int] = field(default_factory=list)
    model_type: int = 1  # TrainerSpec.model_type: 1 = UNIGRAM, 2 = BPE
    unk_id: int = 0
    normalizer_name: str = "identity"
    precompiled_charsmap: bytes = b""
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True
    escape_whitespaces: bool = True


def parse_model_proto(data: bytes) -> ModelProto:
    model = ModelProto()
    for fnum, wtype, val in _iter_fields(data):
        if fnum == 1 and wtype == 2:  # repeated SentencePiece pieces
            piece, score, ptype = "", 0.0, NORMAL
            for pf, pw, pv in _iter_fields(val):
                if pf == 1:
                    piece = pv.decode("utf-8")
                elif pf == 2:
                    score = struct.unpack("<f", pv)[0]
                elif pf == 3:
                    ptype = pv
            model.pieces.append(piece)
            model.scores.append(score)
            model.types.append(ptype)
        elif fnum == 2 and wtype == 2:  # TrainerSpec
            for tf, tw, tv in _iter_fields(val):
                if tf == 3:  # model_type
                    model.model_type = tv
                elif tf == 40:  # unk_id
                    model.unk_id = tv
        elif fnum == 3 and wtype == 2:  # NormalizerSpec
            for nf, nw, nv in _iter_fields(val):
                if nf == 1:
                    model.normalizer_name = nv.decode("utf-8")
                elif nf == 2:
                    model.precompiled_charsmap = nv
                elif nf == 3:
                    model.add_dummy_prefix = bool(nv)
                elif nf == 4:
                    model.remove_extra_whitespaces = bool(nv)
                elif nf == 5:
                    model.escape_whitespaces = bool(nv)
    return model


def build_model_proto(
    pieces: list[tuple[str, float, int]],
    model_type: int = 1,
    unk_id: int = 0,
    add_dummy_prefix: bool = True,
    normalizer_name: str = "identity",
    precompiled_charsmap: bytes = b"",
) -> bytes:
    """Serialize a minimal unigram ModelProto (test fixtures / tooling)."""
    out = bytearray()
    for piece, score, ptype in pieces:
        body = bytearray()
        _write_field(body, 1, 2, piece.encode("utf-8"))
        _write_field(body, 2, 5, struct.pack("<f", score))
        _write_field(body, 3, 0, ptype)
        _write_field(out, 1, 2, bytes(body))
    trainer = bytearray()
    _write_field(trainer, 3, 0, model_type)
    _write_field(trainer, 40, 0, unk_id)
    _write_field(out, 2, 2, bytes(trainer))
    normalizer = bytearray()
    _write_field(normalizer, 1, 2, normalizer_name.encode("utf-8"))
    if precompiled_charsmap:
        _write_field(normalizer, 2, 2, precompiled_charsmap)
    _write_field(normalizer, 3, 0, 1 if add_dummy_prefix else 0)
    _write_field(out, 3, 2, bytes(normalizer))
    return bytes(out)


# ------------------------------------------------------- precompiled charsmap
#
# sentencepiece ships its normalization (NFKC et al.) as a `precompiled
# charsmap`: [uint32 LE trie_size][darts-clone double-array trie over UTF-8
# key prefixes][pool of NUL-terminated replacement strings]. Each trie value
# is a byte offset into the pool. Normalization is a longest-prefix-match
# greedy rewrite over the input bytes. The double-array unit encoding
# (darts_clone DoubleArrayUnit):
#   bits 0-7  : label (the matched byte)          — label() = unit & 0x800000FF
#   bit 8     : has_leaf                          — a value hangs off label 0
#   bit 9     : offset-extension flag (<<8)
#   bits 10-30: offset                            — offset() = (u>>10) << ((u>>6)&0x100? ...)
#   bit 31    : leaf-value unit flag (value() = unit & 0x7FFFFFFF)


def _unit_offset(u: int) -> int:
    return (u >> 10) << ((u & (1 << 9)) >> 6)


class _Charsmap:
    """Reader for the precompiled charsmap blob (darts commonPrefixSearch)."""

    def __init__(self, blob: bytes):
        if len(blob) < 4:
            raise ValueError("precompiled charsmap blob too short for header")
        (trie_size,) = struct.unpack_from("<I", blob, 0)
        if trie_size % 4 or 4 + trie_size > len(blob):
            raise ValueError(
                f"corrupt precompiled charsmap: trie_size={trie_size} "
                f"exceeds blob of {len(blob)} bytes"
            )
        n_units = trie_size // 4
        self.units = struct.unpack_from(f"<{n_units}I", blob, 4)
        self.pool = blob[4 + trie_size :]

    def longest_match(self, data: bytes, start: int):
        """Longest prefix of data[start:] in the trie -> (length, replacement
        bytes) or None."""
        units = self.units
        node_pos = _unit_offset(units[0])
        longest = None
        for i in range(start, len(data)):
            c = data[i]
            node_pos ^= c
            if node_pos >= len(units):
                break
            unit = units[node_pos]
            if (unit & 0x800000FF) != c:
                break
            node_pos ^= _unit_offset(unit)
            if (unit >> 8) & 1:
                # Bounds-check ONLY the leaf-value read: a darts base may
                # legally exceed the array as long as base^label stays
                # inside (checked at the top of the loop); but a leaf read
                # at an out-of-range base means a corrupt blob and must not
                # IndexError deep inside encode().
                if node_pos >= len(units):
                    break
                value = units[node_pos] & 0x7FFFFFFF
                longest = (i - start + 1, value)
        if longest is None:
            return None
        ln, value = longest
        end = self.pool.find(b"\0", value)
        return ln, self.pool[value : end if end >= 0 else len(self.pool)]

    def normalize_bytes(self, data: bytes) -> bytes:
        out = bytearray()
        i, n = 0, len(data)
        while i < n:
            m = self.longest_match(data, i)
            if m is not None:
                ln, rep = m
                out += rep
                i += ln
            else:  # copy one UTF-8 character unchanged
                b = data[i]
                ln = 1 if b < 0x80 else (2 if b < 0xE0 else (3 if b < 0xF0 else 4))
                out += data[i : i + ln]
                i += ln
        return bytes(out)


def build_precompiled_charsmap(mapping: dict[str, str]) -> bytes:
    """Serialize a charsmap blob from {source: replacement} (test fixtures /
    tooling): builds a darts-clone-compatible double-array for the key set.
    sentencepiece's own blobs (NFKC: ~a million units) read back through
    _Charsmap with the identical traversal."""
    pool = bytearray()
    keys_vals: list[tuple[bytes, int]] = []
    for k, v in sorted(mapping.items()):
        keys_vals.append((k.encode("utf-8"), len(pool)))
        pool += v.encode("utf-8") + b"\0"

    trie: dict = {}
    for key, val in keys_vals:
        node = trie
        for b in key:
            node = node.setdefault(b, {})
        node[None] = val  # terminal marker

    units: dict[int, int] = {0: 0}

    def place(pos: int, node: dict) -> None:
        labels = sorted(l for l in node if l is not None)
        targets = ([0] if None in node else []) + labels
        off = 1
        while True:
            cand = [pos ^ off ^ c for c in targets]
            if (
                off < (1 << 21)
                and len(set(cand)) == len(cand)
                and all(p not in units and p != 0 for p in cand)
            ):
                break
            off += 1
        units[pos] = units[pos] | (off << 10) | ((1 << 8) if None in node else 0)
        for c in targets:
            p = pos ^ off ^ c
            if c == 0 and None in node:
                units[p] = 0x80000000 | node[None]
            else:
                units[p] = c
        for c in labels:
            place(pos ^ off ^ c, node[c])

    place(0, trie)
    n_units = max(units) + 1
    arr = [units.get(i, 0) for i in range(n_units)]
    return struct.pack("<I", 4 * n_units) + struct.pack(f"<{n_units}I", *arr) + bytes(pool)


def _nfkc_fallback(text: str, casefold: bool) -> str:
    """Approximate nmt_nfkc when a model embeds no charsmap: unicodedata NFKC
    plus the NMT whitespace/control conventions (tab/newline and unicode
    spaces -> ASCII space, zero-width/control characters removed)."""
    import unicodedata

    text = unicodedata.normalize("NFKC", text)
    out = []
    for ch in text:
        if ch in ("\t", "\n", "\r", "\v", "\f"):
            out.append(" ")
            continue
        cat = unicodedata.category(ch)
        if cat == "Zs":
            out.append(" ")
        elif cat in ("Cc", "Cf"):
            continue  # drop controls / zero-width formatting
        else:
            out.append(ch)
    text = "".join(out)
    return text.casefold() if casefold else text


# ------------------------------------------------------------------- encoder

_UNK_PENALTY = 10.0  # sentencepiece's kUnkPenalty


class SentencePieceProcessor:
    """Drop-in subset of `sentencepiece.SentencePieceProcessor` (unigram)."""

    def __init__(self, model_path: str | None = None, model_proto: bytes | None = None):
        if model_proto is None:
            with open(model_path, "rb") as fh:
                model_proto = fh.read()
        self._m = parse_model_proto(model_proto)
        if self._m.model_type != 1:
            raise ValueError(
                f"pure-Python SentencePiece supports unigram models only "
                f"(model_type={self._m.model_type}); install `sentencepiece`"
            )
        self._piece_to_id = {p: i for i, p in enumerate(self._m.pieces)}
        self._max_piece_len = max((len(p) for p in self._m.pieces), default=1)
        scorable = [
            s
            for s, t in zip(self._m.scores, self._m.types)
            if t in (NORMAL, USER_DEFINED)
        ]
        min_score = min(scorable, default=0.0)
        self._unk_score = min_score - _UNK_PENALTY
        self._byte_ids = {
            int(p[1:-1], 16): i
            for i, (p, t) in enumerate(zip(self._m.pieces, self._m.types))
            if t == BYTE and p.startswith("<0x") and p.endswith(">")
        }
        self._charsmap = (
            _Charsmap(self._m.precompiled_charsmap)
            if self._m.precompiled_charsmap
            else None
        )

    # -- vocab ----------------------------------------------------------

    def vocab_size(self) -> int:
        return len(self._m.pieces)

    def get_piece_size(self) -> int:
        return self.vocab_size()

    def id_to_piece(self, idx: int) -> str:
        return self._m.pieces[idx]

    def piece_to_id(self, piece: str) -> int:
        return self._piece_to_id.get(piece, self._m.unk_id)

    # -- normalize ------------------------------------------------------

    def _normalize(self, text: str) -> str:
        if self._charsmap is not None:
            # Exact path: the model's own precompiled NFKC (or other) map.
            text = self._charsmap.normalize_bytes(text.encode("utf-8")).decode(
                "utf-8", errors="replace"
            )
        elif "nfkc" in self._m.normalizer_name:
            text = _nfkc_fallback(text, casefold=self._m.normalizer_name.endswith("_cf"))
        if self._m.remove_extra_whitespaces:
            text = " ".join(text.split())
        if self._m.add_dummy_prefix and text:
            text = " " + text
        if self._m.escape_whitespaces:
            text = text.replace(" ", _WHITESPACE_PIECE)
        return text

    # -- encode (unigram Viterbi) ----------------------------------------

    def _viterbi_pieces(self, s: str) -> list[int]:
        n = len(s)
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        back: list[tuple[int, int]] = [(-1, -1)] * (n + 1)  # (start, piece_id)
        best[0] = 0.0
        types = self._m.types
        for end in range(1, n + 1):
            lo = max(0, end - self._max_piece_len)
            for start in range(lo, end):
                if best[start] == NEG:
                    continue
                piece = s[start:end]
                pid = self._piece_to_id.get(piece)
                if pid is not None and types[pid] in (NORMAL, USER_DEFINED):
                    cand = best[start] + self._m.scores[pid]
                    if cand > best[end]:
                        best[end] = cand
                        back[end] = (start, pid)
            # unknown single character (or byte-fallback, resolved later)
            if best[end - 1] != NEG:
                cand = best[end - 1] + self._unk_score
                if cand > best[end]:
                    best[end] = cand
                    back[end] = (end - 1, -1)

        ids: list[int] = []
        pos = n
        while pos > 0:
            start, pid = back[pos]
            if pid >= 0:
                ids.append(pid)
            else:
                ch = s[start:pos]
                if self._byte_ids:
                    for b in reversed(ch.encode("utf-8")):
                        ids.append(self._byte_ids.get(b, self._m.unk_id))
                else:
                    ids.append(self._m.unk_id)
            pos = start
        ids.reverse()
        return ids

    def encode(self, text: str, out_type=int) -> list:
        ids = self._viterbi_pieces(self._normalize(text))
        if out_type is int:
            return ids
        return [self._m.pieces[i] for i in ids]

    def encode_as_ids(self, text: str) -> list[int]:
        return self.encode(text, out_type=int)

    def encode_as_pieces(self, text: str) -> list[str]:
        return self.encode(text, out_type=str)

    # -- decode ----------------------------------------------------------

    def decode(self, ids: list[int]) -> str:
        out: list[str] = []
        pending_bytes: list[int] = []

        def flush():
            if pending_bytes:
                out.append(bytes(pending_bytes).decode("utf-8", errors="replace"))
                pending_bytes.clear()

        for i in ids:
            piece = self._m.pieces[i]
            ptype = self._m.types[i]
            if ptype == BYTE:
                pending_bytes.append(int(piece[1:-1], 16))
                continue
            flush()
            if ptype in (CONTROL, UNUSED):
                continue
            if ptype == UNKNOWN:
                out.append(" ⁇ ")  # sentencepiece renders unk as ' ⁇ '
                continue
            out.append(piece)
        flush()
        text = "".join(out).replace(_WHITESPACE_PIECE, " ")
        return text[1:] if text.startswith(" ") else text

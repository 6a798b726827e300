"""Plain float32 PyTorch reference of Kyutai's pocket-tts (FlowLM + Mimi).

It imports nothing of the program under test. It makes the seeded weights
the benchmark hands to the program (in the program's parameter-tree layout,
which is the checkpoint's module layout), applies the weight precision the
configuration states (bf16 storage, int8 FlowLM linears with per-output-row
absmax scales) and the FlowLM numerics it states (Numerics: the KV cache's
storage, the attention's bf16 casts, and for a stream decoded alone the B=1
kernels' bf16 GEMM inputs and bf16 flow head) on its own, and computes
everything else in float32 with TF32 off: the text and voice prompt, greedy
FlowLM decoding (temperature 0, so the flow starts from zero noise), the
flow-matching head, the Mimi decoder down to 24 kHz PCM, and for voice
cloning the WAV read, the resampling to 24 kHz, the Mimi encoder and the
speaker projection.

Departures from the published description: none in the equations. The
reference decodes the Mimi latents of a request in one whole-sequence pass
(causal convolutions left-padded, transposed convolutions cut to the
streamed length, windowed attention over absolute positions), which equals
the streamed decode; the one zero latent frame that warms the streaming
decoder up is decoded first and its audio dropped, as a served request does.
The tokenizer is the offline hash tokenizer (the SentencePiece model cannot
be fetched), kept here as an input asset.
"""

from __future__ import annotations

import hashlib
import math
import re
import wave
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

FRAME_SAMPLES = 1920  # 24 kHz / 12.5 Hz
TOKENS_PER_SECOND = 3.0
GEN_SECONDS_PADDING = 2.0
MAX_TOKENS_PER_CHUNK = 50
_EOS_RESERVED = 64


# ----------------------------------------------------------------- tokenizer


class Tokenized(NamedTuple):
    tokens: np.ndarray  # int32 [1, T]


class HashTokenizer:
    """The offline tokenizer: punctuation runs and whitespace-led words,
    each an md5 hash into [0, n_bins); ids below 64 are sentence ends."""

    def __init__(self, n_bins: int):
        self.n_bins = n_bins
        self._pieces: dict[int, str] = {}

    def _piece_id(self, piece: str) -> int:
        h = int.from_bytes(hashlib.md5(piece.encode()).digest()[:4], "little")
        if re.fullmatch(r"[.!?]+", piece):
            token = h % _EOS_RESERVED
        else:
            token = _EOS_RESERVED + h % (self.n_bins - _EOS_RESERVED)
        self._pieces[token] = piece
        return token

    def encode(self, text: str) -> list[int]:
        return [self._piece_id(p) for p in re.findall(r"[.!?]+|\s*[^\s.!?]+", text)]

    def decode(self, tokens: list[int]) -> str:
        return "".join(self._pieces.get(t, "") for t in tokens)

    def end_of_sentence_tokens(self) -> set[int]:
        return set(range(_EOS_RESERVED))

    def __call__(self, text: str) -> Tokenized:
        return Tokenized(np.asarray(self.encode(text), dtype=np.int32)[None, :])


def prepare_text(text: str) -> str:
    """The published prompt normalisation: one line, a capital, a final
    period, and 8 spaces before a prompt of fewer than 5 words."""
    text = text.strip().replace("\n", " ").replace("\r", " ").replace("  ", " ")
    if not text:
        raise ValueError("empty text")
    if not text[0].isupper():
        text = text[0].upper() + text[1:]
    if text[-1].isalnum():
        text = text + "."
    if len(text.split()) < 5:
        text = " " * 8 + text
    return text


def text_chunks(tokenizer: HashTokenizer, text: str, max_tokens: int = MAX_TOKENS_PER_CHUNK) -> list[list[int]]:
    """Token ids of each sentence-packed chunk of at most max_tokens tokens
    (the published packing), each chunk decoded from the voice afresh."""
    tokens = tokenizer.encode(prepare_text(text).strip())
    eos = tokenizer.end_of_sentence_tokens()
    bounds, prev = [0], False
    for i, t in enumerate(tokens):
        if t in eos:
            prev = True
        else:
            if prev:
                bounds.append(i)
            prev = False
    bounds.append(len(tokens))
    chunks, cur, n_cur = [], "", 0
    for a, b in zip(bounds[:-1], bounds[1:]):
        sentence, n = tokenizer.decode(tokens[a:b]), b - a
        if not cur:
            cur, n_cur = sentence, n
        elif n_cur + n > max_tokens:
            chunks.append(cur.strip())
            cur, n_cur = sentence, n
        else:
            cur, n_cur = cur + " " + sentence, n_cur + n
    if cur:
        chunks.append(cur.strip())
    return [tokenizer.encode(c) for c in chunks]


def max_frames(n_tokens: int, frame_rate: float = 12.5) -> int:
    """Frames a chunk of n_tokens decodes with end-of-speech disabled."""
    return math.ceil((n_tokens / TOKENS_PER_SECOND + GEN_SECONDS_PADDING) * frame_rate)


def request_frames(tokenizer: HashTokenizer, text: str, frame_rate: float = 12.5) -> int:
    return sum(max_frames(len(c), frame_rate) for c in text_chunks(tokenizer, text))


# ------------------------------------------------------------------ weights


def _layout(cfg: dict) -> list:
    """(path, shape, init) of every weight, in the checkpoint's module
    layout. init: ("u", bound) uniform(-bound, bound); ("n", std) normal;
    ("one", jitter) 1 + uniform(-jitter, jitter); ("const", value, jitter)."""
    fl, mi = cfg["flow_lm"], cfg["mimi"]
    t = fl["transformer"]
    E, H, L = t["d_model"], t["num_heads"], t["num_layers"]
    Fd = E * t["hidden_scale"]
    mc, depth = fl["flow"]["dim"], fl["flow"]["depth"]
    ld = mi["quantizer"]["dimension"]
    sd = mi["seanet"]["dimension"]
    out = []

    def lin(path, o, i, bias=True):
        out.append((path + ("weight",), (o, i), ("u", 1 / math.sqrt(i))))
        if bias:
            out.append((path + ("bias",), (o,), ("u", 1 / math.sqrt(i))))

    def norm(path, d):
        out.append((path + ("weight",), (d,), ("one", 0.1)))
        out.append((path + ("bias",), (d,), ("u", 0.1)))

    def xf_layer(path, d, ff, scale):
        out.append((path + ("self_attn", "in_proj", "weight"), (3, d, d), ("u", 1 / math.sqrt(d))))
        out.append((path + ("self_attn", "out_proj", "weight"), (d, d), ("u", 1 / math.sqrt(d))))
        norm(path + ("norm1",), d)
        norm(path + ("norm2",), d)
        lin(path + ("linear1",), ff, d, bias=False)
        lin(path + ("linear2",), d, ff, bias=False)
        if scale is not None:
            for name in ("layer_scale_1", "layer_scale_2"):
                out.append((path + (name, "scale"), (d,), ("const", scale, 0.1)))

    f = ("flow_lm",)
    out.append((f + ("conditioner", "embed", "weight"), (fl["lookup_table"]["n_bins"] + 1, E), ("n", 0.02)))
    fn = f + ("flow_net",)
    for i in range(2):
        lin(fn + ("time_embed", i, "mlp", 0), mc, 256)
        lin(fn + ("time_embed", i, "mlp", 2), mc, mc)
        out.append((fn + ("time_embed", i, "mlp", 3, "alpha"), (mc,), ("one", 0.1)))
    lin(fn + ("cond_embed",), mc, E)
    lin(fn + ("input_proj",), mc, ld)
    lin(fn + ("final_layer", "linear"), ld, mc)
    lin(fn + ("final_layer", "adaLN_modulation", 1), 2 * mc, mc)
    for b in range(depth):
        rb = fn + ("res_blocks", b)
        norm(rb + ("in_ln",), mc)
        lin(rb + ("mlp", 0), mc, mc)
        lin(rb + ("mlp", 2), mc, mc)
        lin(rb + ("adaLN_modulation", 1), 3 * mc, mc)
    for layer in range(L):
        xf_layer(f + ("transformer", "layers", layer), E, Fd, None)
    lin(f + ("input_linear",), E, ld, bias=False)
    norm(f + ("out_norm",), E)
    lin(f + ("out_eos",), 1, E)
    out.append((f + ("bos_emb",), (ld,), ("n", 1.0)))
    out.append((f + ("emb_std",), (ld,), ("one", 0.1)))
    out.append((f + ("emb_mean",), (ld,), ("u", 0.1)))
    out.append((f + ("speaker_proj_weight",), (E, sd), ("n", 0.02)))

    m = ("mimi",)
    mt = mi["transformer"]
    for side in ("decoder", "encoder"):
        for i, (kind, cin, cout, k, _, _) in enumerate(_seanet_chain(mi["seanet"], side)):
            if kind == "res":
                h = cin // mi["seanet"]["compress"]
                for j, (a, b, kk) in ((1, (cin, h, mi["seanet"]["residual_kernel_size"])), (3, (h, cin, 1))):
                    base = m + (side, "model", i, "block", j, "conv")
                    out.append((base + ("weight",), (b, a, kk), ("u", 1 / math.sqrt(a * kk))))
                    out.append((base + ("bias",), (b,), ("const", 0.0, 0.0)))
            elif kind in ("conv", "convtr"):
                base = m + (side, "model", i, kind)
                shape = (cout, cin, k) if kind == "conv" else (cin, cout, k)
                out.append((base + ("weight",), shape, ("u", 1 / math.sqrt(cin * k))))
                out.append((base + ("bias",), (cout,), ("const", 0.0, 0.0)))
        tr = m + (f"{side}_transformer",)
        for layer in range(mt["num_layers"]):
            xf_layer(tr + ("transformer", "layers", layer), mt["d_model"], mt["dim_feedforward"], mt["layer_scale"])
    out.append((m + ("quantizer", "output_proj", "weight"), (mi["quantizer"]["output_dimension"], ld, 1),
                ("u", 1 / math.sqrt(ld))))
    stride = _resample_stride(mi)
    out.append((m + ("upsample", "convtr", "convtr", "weight"), (sd, 1, 2 * stride), ("u", 1 / math.sqrt(2 * stride))))
    out.append((m + ("downsample", "conv", "conv", "weight"), (sd, sd, 2 * stride),
                ("u", 1 / math.sqrt(sd * 2 * stride))))
    return out


def _resample_stride(mi: dict) -> int:
    return int(mi["sample_rate"] / math.prod(mi["seanet"]["ratios"]) / mi["frame_rate"])


def _seanet_chain(s: dict, side: str) -> list:
    """(kind, in, out, kernel, stride, dilation) of each slot of the SEANet
    chain: 'conv', 'convtr', 'res' (residual block) or 'elu'."""
    nf, ratios = s["n_filters"], s["ratios"]
    if side == "decoder":
        mult = 2 ** len(ratios)
        chain = [("conv", s["dimension"], mult * nf, s["kernel_size"], 1, 1)]
        for r in ratios:
            chain += [("elu",) + (0,) * 5, ("convtr", mult * nf, mult * nf // 2, 2 * r, r, 1)]
            chain += [("res", mult * nf // 2, mult * nf // 2, 0, 1, s["dilation_base"] ** j)
                      for j in range(s["n_residual_layers"])]
            mult //= 2
        return chain + [("elu",) + (0,) * 5, ("conv", nf, s["channels"], s["last_kernel_size"], 1, 1)]
    mult = 1
    chain = [("conv", s["channels"], nf, s["kernel_size"], 1, 1)]
    for r in reversed(ratios):
        chain += [("res", mult * nf, mult * nf, 0, 1, s["dilation_base"] ** j)
                  for j in range(s["n_residual_layers"])]
        chain += [("elu",) + (0,) * 5, ("conv", mult * nf, 2 * mult * nf, 2 * r, r, 1)]
        mult *= 2
    return chain + [("elu",) + (0,) * 5, ("conv", mult * nf, s["dimension"], s["last_kernel_size"], 1, 1)]


def _set(tree: dict, path: tuple, value) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, list):
            while len(node) <= key:
                node.append({})
            node = node[key]
            continue
        if key not in node:
            node[key] = [] if isinstance(nxt, int) else {}
        node = node[key]
    if isinstance(node, list):
        while len(node) <= path[-1]:
            node.append({})
    node[path[-1]] = value


def make_params(cfg: dict, seed: int, device) -> dict:
    """The float32 weights of `cfg` from `seed`, made on `device` in two
    draws (one uniform, one normal) and sliced into the checkpoint's tree
    (nested dicts and lists; parameterless slots, such as an ELU, are {})."""
    layout = _layout(cfg)
    sizes = [math.prod(shape) for _, shape, _ in layout]
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2**63))
    uni = torch.rand(sum(sizes), generator=gen, device=device, dtype=torch.float32).mul_(2).sub_(1)
    nor = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    tree: dict = {}
    off = 0
    for (path, shape, init), n in zip(layout, sizes):
        u, g = uni[off : off + n].view(shape), nor[off : off + n].view(shape)
        off += n
        kind = init[0]
        if kind == "u":
            leaf = u * init[1]
        elif kind == "n":
            leaf = g * init[1]
        elif kind == "one":
            leaf = 1 + u * init[1]
        else:
            leaf = init[1] * (1 + u * init[2])
        _set(tree, path, leaf)
    for side in ("decoder", "encoder"):  # the identity output projection of each Mimi transformer
        tree["mimi"][f"{side}_transformer"]["output_projs"] = [{}]
    return tree


def serving_weights(params: dict, param_dtype: str, weight_bits: int = 8) -> dict:
    """The weights as the configuration serves them, widened to float32.
    param_dtype "float32": as made. "bfloat16": every tensor of two or more
    dimensions rounded to bf16, except the float32 islands (the flow head,
    the EOS head, the output norm). "int8": that, then every FlowLM backbone
    and input-projection matrix quantised per output row to signed
    `weight_bits`-bit codes with scale max|w| / (2^(bits-1) - 1) (round
    half to even) and dequantised (the int4_weights control: weight_bits 4)."""
    if param_dtype == "float32":
        return params

    def quant(w, bits, dims):
        qmax = 2 ** (bits - 1) - 1
        scale = w.abs().amax(dim=dims, keepdim=True).clamp(min=1e-12) / qmax
        return torch.round(w / scale).clamp(-qmax, qmax) * scale

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path + (i,)) for i, v in enumerate(node)]
        w = node.float()
        if w.ndim < 2 or {"flow_net", "out_eos", "out_norm"} & set(path):
            return w
        w = w.to(torch.bfloat16).float()
        if (param_dtype == "int8" and path[0] == "flow_lm" and path[1] in ("transformer", "input_linear")
                and path[-1] == "weight"):
            return quant(w, weight_bits, -1)
        return w

    return walk(params, ())


# ------------------------------------------------------------ rounding


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _fp8(x):
    """float8 e4m3 with one scale per row (absmax / 448)."""
    s = x.abs().amax(-1, keepdim=True).clamp(min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _exact(x):
    return x


ROUND = {"float32": _exact, "bfloat16": _bf16, "float8_e4m3": _fp8}
LOWER = {"float32": "bfloat16", "bfloat16": "float8_e4m3"}  # one precision step down


# ------------------------------------------------------------------ layers


def _ln(x, w=None, b=None, eps=1e-5):
    return F.layer_norm(x, x.shape[-1:], w, b, eps)


def _rope(x, pos, max_period):
    """Interleaved-pair rotary embedding of x [T, H, d] at positions [T]."""
    d = x.shape[-1]
    freqs = torch.exp(torch.arange(d // 2, device=x.device, dtype=torch.float32) * (-math.log(max_period) * 2 / d))
    ang = pos.float()[:, None, None] * freqs
    xr, xi = x[..., 0::2], x[..., 1::2]
    return torch.stack([xr * ang.cos() - xi * ang.sin(), xr * ang.sin() + xi * ang.cos()], dim=-1).flatten(-2)


def _ff(lp, x, rnd=_exact):
    return F.linear(rnd(F.gelu(F.linear(rnd(x), lp["linear1"]["weight"]))), lp["linear2"]["weight"])


def _qkv(lp, h, heads, rnd=_exact):
    q, k, v = (F.linear(rnd(h), w).unflatten(-1, (heads, -1)) for w in lp["self_attn"]["in_proj"]["weight"])
    return q, k, v


# ---------------------------------------------------------------- numerics


# The controls: the reference one precision step below what the
# configuration states, in one place each.
CONTROLS = {
    "fp8_gemm": "every bf16 GEMM and convolution input (FlowLM backbone, Mimi) lowered to float8 e4m3, a scale per row",
    "bf16_flow_head": "the flow head that runs in float32 (the plain path's) in bf16: its matrices and GEMM inputs",
    "int8_kv": "the bf16 KV cache lowered to int8 rows with a float32 scale each",
    "int4_weights": "the int8 FlowLM matrices lowered to int4 codes per output row",
}


class Numerics:
    """Where the served model rounds, from the configuration's `numerics`:
    `gemm_inputs`, the dtype every GEMM and convolution input is cast to
    when its matrix is stored in bf16 or int8 (the FlowLM backbone and
    input projection, Mimi; float32 products and sums), `flow_head`, the
    dtype of the flow head's matrices and GEMM inputs on the plain path,
    `mimi_decoder`, the dtype of the Mimi decoder's activations,
    `kv_cache` ("float32", "bfloat16" or "int8_rows": one absmax scale per
    cache row over its H*d values, codes rounded half to even), `attention`
    (the dtype q and the softmax weights, times the V scale of an int8 row,
    are cast to before their products; scores, softmax and sums in
    float32), and `stream_kernels`: for a request decoded alone through the
    streaming API, the B=1 kernels, whose backbone rounds as the plain path
    does and whose whole `segment_multiple`-frame segments run the flow
    head at `flow_head`; the segments run 1, 2, 4, ... doubling to
    `steady_frames`, the tail rounded up to a power of two. `control` (a key
    of CONTROLS) lowers one of them a step."""

    def __init__(self, cfg: dict, control: str | None = None):
        n = cfg["numerics"]
        if control is not None and control not in CONTROLS:
            raise ValueError(f"unknown control {control!r}; known: {sorted(CONTROLS)}")
        self.gemm = ROUND[LOWER[n["gemm_inputs"]] if control == "fp8_gemm" else n["gemm_inputs"]]
        self.mimi_decoder = ROUND[n["mimi_decoder"]]
        self.flow = ROUND[LOWER[n["flow_head"]] if control == "bf16_flow_head" else n["flow_head"]]
        self.kv = "int8_rows" if control == "int8_kv" and n["kv_cache"] == "bfloat16" else n["kv_cache"]
        self.attn = ROUND[n["attention"]]
        k = n.get("stream_kernels")
        self.kernels = dict(k, flow=ROUND[k["flow_head"]]) if k else None

    def stream_segments(self, frames: int) -> list[int]:
        k, sched, total, s = self.kernels, [], 0, 1
        while total < frames:
            rem = frames - total
            if s > rem:
                s = 1 << (rem - 1).bit_length()
            sched.append(s)
            total += s
            s = min(s * 2, k["steady_frames"])
        return sched

    def kernel_flow_frames(self, frames: int) -> list[bool]:
        """For each frame of a streamed chunk: whether its flow head runs in
        the segment kernel."""
        out = []
        for s in self.stream_segments(frames):
            out += [s % self.kernels["segment_multiple"] == 0] * s
        return out[:frames]


class FlowLM:
    """Greedy FlowLM decoding of one stream over a cache stored as the
    configuration states (Numerics)."""

    def __init__(self, W: dict, cfg: dict, numerics: Numerics):
        self.W, self.t = W["flow_lm"], cfg["flow_lm"]["transformer"]
        self.heads = self.t["num_heads"]
        self.nx = numerics

    def _lin(self, x, w):
        return F.linear(self.nx.gemm(x), w)

    def _store(self, x):
        """K or V rows [T, H, d] as the cache holds them -> (rows, scale [T])."""
        if self.nx.kv == "int8_rows":
            amax = x.abs().amax(dim=(1, 2))
            scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
            return torch.clamp(torch.round(x / scale[:, None, None]), -127, 127), scale
        one = torch.ones(x.shape[0], device=x.device)
        return (_bf16(x) if self.nx.kv == "bfloat16" else x), one

    def _block(self, lp, x, pos, cache):
        h = _ln(x, lp["norm1"]["weight"], lp["norm1"]["bias"])
        q, k, v = (self._lin(h, w).unflatten(-1, (self.heads, -1)) for w in lp["self_attn"]["in_proj"]["weight"])
        q, k = _rope(q, pos, self.t["max_period"]), _rope(k, pos, self.t["max_period"])
        (kr, ks), (vr, vs) = self._store(k), self._store(v)
        for name, new in (("k", kr), ("v", vr), ("ks", ks), ("vs", vs), ("pos", pos)):
            cache[name] = torch.cat([cache[name], new]) if name in cache else new
        s = torch.einsum("qhd,khd->hqk", self.nx.attn(q), cache["k"]) * (cache["ks"] / math.sqrt(q.shape[-1]))
        s = s.masked_fill(~(cache["pos"][None, :] <= pos[:, None]), float("-inf"))
        w = self.nx.attn(torch.softmax(s, dim=-1) * cache["vs"])
        out = torch.einsum("hqk,khd->qhd", w, cache["v"])
        x = x + self._lin(out.flatten(-2), lp["self_attn"]["out_proj"]["weight"])
        h = _ln(x, lp["norm2"]["weight"], lp["norm2"]["bias"])
        return x + self._lin(F.gelu(self._lin(h, lp["linear1"]["weight"])), lp["linear2"]["weight"])

    def run(self, x, caches, pos0):
        pos = torch.arange(pos0, pos0 + x.shape[0], device=x.device)
        for lp, cache in zip(self.W["transformer"]["layers"], caches):
            x = self._block(lp, x, pos, cache)
        return x

    def flow(self, h, x0, rnd=_exact):
        """One Euler step of the flow-matching head from x0 (s=0, t=1), its
        matrices and GEMM inputs rounded by `rnd` (the time embedding stays
        float32)."""
        p = self.W["flow_net"]

        def lin(x, m):
            return F.linear(rnd(x), rnd(m["weight"]), m["bias"])

        ts = [torch.zeros(h.shape[0], 1, device=h.device), torch.ones(h.shape[0], 1, device=h.device)]
        y = sum(_time_embed(p["time_embed"][i], ts[i]) for i in range(2)) / 2
        y = y + lin(h, p["cond_embed"])
        sy = F.silu(y)
        x = lin(x0, p["input_proj"])
        for blk in p["res_blocks"]:
            shift, scale, gate = lin(sy, blk["adaLN_modulation"][1]).chunk(3, dim=-1)
            z = _ln(x, blk["in_ln"]["weight"], blk["in_ln"]["bias"], 1e-6) * (1 + scale) + shift
            z = F.silu(lin(z, blk["mlp"][0]))
            x = x + gate * lin(z, blk["mlp"][2])
        fin = p["final_layer"]
        shift, scale = lin(sy, fin["adaLN_modulation"][1]).chunk(2, -1)
        x = _ln(x, eps=1e-6) * (1 + scale) + shift
        return x0 + lin(x, fin["linear"])

    def generate(self, prompt: torch.Tensor, tokens: list[int], frames: int, alone: bool = False) -> torch.Tensor:
        """Latents [frames, ldim] of one chunk: the voice prompt [P, E] and
        the text's LUT rows prefilled, then `frames` greedy steps from BOS.
        alone: the chunk is decoded by itself through the streaming API (the
        B=1 kernels, where the configuration has them)."""
        W, nx = self.W, self.nx
        kernels = nx.kernels if alone else None
        in_kernel = nx.kernel_flow_frames(frames) if kernels else [False] * frames
        caches = [{} for _ in W["transformer"]["layers"]]
        text = W["conditioner"]["embed"]["weight"][torch.tensor(tokens, device=prompt.device)]
        self.run(torch.cat([prompt, text]), caches, 0)
        pos = prompt.shape[0] + len(tokens)
        latent = W["bos_emb"][None]
        out = []
        for f in range(frames):
            x = self.run(self._lin(latent, W["input_linear"]["weight"]), caches, pos + f)
            h = _ln(x, W["out_norm"]["weight"], W["out_norm"]["bias"])
            latent = self.flow(h, torch.zeros_like(latent), kernels["flow"] if in_kernel[f] else nx.flow)
            out.append(latent)
        return torch.cat(out)


def _time_embed(p, t):
    half = 128
    freqs = torch.exp(-math.log(10000) * torch.arange(half, device=t.device, dtype=torch.float32) / half)
    args = t * freqs[None]
    x = F.silu(F.linear(torch.cat([args.cos(), args.sin()], -1), p["mlp"][0]["weight"], p["mlp"][0]["bias"]))
    x = F.linear(x, p["mlp"][2]["weight"], p["mlp"][2]["bias"])
    var = ((x - x.mean(-1, keepdim=True)) ** 2).sum(-1, keepdim=True) / (x.shape[-1] - 1)
    return x * p["mlp"][3]["alpha"] * torch.rsqrt(1e-5 + var)


def _causal_conv(x, p, stride=1, dilation=1, pad="constant", rnd=_exact):
    """Causal Conv1d over a whole sequence x [C, T] (its input rounded by
    `rnd`): left padding by the streamed overlap (k - 1) * dilation + 1 -
    stride."""
    w, x = p["weight"], rnd(x)
    overlap = (w.shape[-1] - 1) * dilation + 1 - stride
    if overlap:
        x = F.pad(x[None], (overlap, 0), mode="replicate" if pad == "replicate" else "constant")[0]
    return F.conv1d(x[None], w, p.get("bias"), stride=stride, dilation=dilation)[0]


def _causal_convtr(x, p, stride, groups=1, rnd=_exact):
    """Streamed ConvTranspose1d over a whole sequence (its input rounded by
    `rnd`): the full output cut to T * stride samples (the tail would
    overlap a next chunk)."""
    y = F.conv_transpose1d(rnd(x)[None], p["weight"], p.get("bias"), stride=stride, groups=groups)[0]
    return y[:, : x.shape[-1] * stride]


class Mimi:
    """The codec. Every convolution and GEMM input is rounded to the
    configuration's `gemm_inputs` (its matrices are stored in bf16). The
    decoder holds its activations at `mimi_decoder`: each operation's result
    is rounded to it, and the scales and biases it adds are cast to it
    (the attention as FlowLM's, over a cache of that dtype); the waveform
    leaves the last convolution in float32. The encoder's activations are
    float32."""

    def __init__(self, W: dict, cfg: dict, numerics: Numerics):
        self.W, self.mi = W["mimi"], cfg["mimi"]
        self.fl = W["flow_lm"]
        self.stride = _resample_stride(self.mi)
        self.rnd, self.dec = numerics.gemm, numerics.mimi_decoder

    def _transformer(self, p, x, a):
        """Windowed causal transformer over a whole sequence x [T, d] at
        positions 0..T-1 (a key j is seen from query i when 0 <= i-j <
        context), activations rounded by `a`."""
        t = self.mi["transformer"]
        pos = torch.arange(x.shape[0], device=x.device)
        delta = pos[:, None] - pos[None, :]
        mask = (delta >= 0) & (delta < t["context"])
        mp = t.get("max_period", 10000.0)
        for lp in p["transformer"]["layers"]:
            h = a(_ln(x, lp["norm1"]["weight"], lp["norm1"]["bias"]))
            q, k, v = (a(y) for y in _qkv(lp, h, t["num_heads"], self.rnd))
            q, k = a(_rope(q, pos, mp)), a(_rope(k, pos, mp))
            s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(q.shape[-1])
            w = a(torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1))
            out = a(torch.einsum("hqk,khd->qhd", w, v))
            o = a(F.linear(self.rnd(out.flatten(-2)), lp["self_attn"]["out_proj"]["weight"]))
            x = a(x + a(a(lp["layer_scale_1"]["scale"]) * o))
            h = a(_ln(x, lp["norm2"]["weight"], lp["norm2"]["bias"]))
            f = a(F.gelu(a(F.linear(self.rnd(h), lp["linear1"]["weight"]))))
            f = a(F.linear(self.rnd(f), lp["linear2"]["weight"]))
            x = a(x + a(a(lp["layer_scale_2"]["scale"]) * f))
        return x

    def _conv(self, x, p, a, stride=1, dilation=1, pad="constant", out=None):
        """A causal convolution, its result rounded by `a` (or `out`) before
        its bias, cast the same way, is added."""
        out = out or a
        y = out(_causal_conv(x, {"weight": p["weight"]}, stride, dilation, pad, rnd=self.rnd))
        return out(y + out(p["bias"])[:, None]) if "bias" in p else y

    def _chain(self, side, x, a):
        s = self.mi["seanet"]
        specs = _seanet_chain(s, side)
        for i, (spec, p) in enumerate(zip(specs, self.W[side]["model"])):
            kind, stride = spec[0], spec[4]
            if kind == "elu":
                x = a(F.elu(x))
            elif kind == "conv":
                last = side == "decoder" and i == len(specs) - 1  # the waveform leaves in float32
                x = self._conv(x, p["conv"], a, stride, pad=s["pad_mode"], out=_exact if last else None)
            elif kind == "convtr":
                c = p["convtr"]
                x = a(_causal_convtr(x, {"weight": c["weight"]}, stride, rnd=self.rnd))
                x = a(x + a(c["bias"])[:, None])
            else:
                v = self._conv(a(F.elu(x)), p["block"][1]["conv"], a, dilation=spec[5], pad=s["pad_mode"])
                x = a(x + self._conv(a(F.elu(v)), p["block"][3]["conv"], a, pad=s["pad_mode"]))
        return x

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Latents [N, ldim] (FlowLM's normalised space) -> PCM [N * 1920]."""
        a = self.dec
        z = torch.cat([torch.zeros_like(latents[:1]), latents])  # the warm-up frame
        z = (z * self.fl["emb_std"] + self.fl["emb_mean"]).T
        x = a(F.conv1d(self.rnd(z)[None], self.W["quantizer"]["output_proj"]["weight"])[0])
        x = a(_causal_convtr(x, self.W["upsample"]["convtr"]["convtr"], self.stride, groups=x.shape[0], rnd=self.rnd))
        x = self._transformer(self.W["decoder_transformer"], x.T, a).T
        return self._chain("decoder", x, a)[0, FRAME_SAMPLES:]

    def encode(self, wav: torch.Tensor) -> torch.Tensor:
        """24 kHz mono PCM [T] -> encoder latents [ceil(T / 1920), 512]."""
        pad = -wav.shape[0] % FRAME_SAMPLES
        x = F.pad(wav, (0, pad))[None]
        x = self._chain("encoder", x, _exact)
        x = self._transformer(self.W["encoder_transformer"], x.T, _exact).T
        return self._conv(x, self.W["downsample"]["conv"]["conv"], _exact, self.stride, pad="replicate").T


# ------------------------------------------------------------------ requests


def synthetic_voice(name: str, frames: int, dim: int, scale: float, device) -> torch.Tensor:
    """The offline stand-in of a predefined voice's embedding asset: a
    normal draw seeded by the sum of the name's bytes, times `scale`."""
    gen = torch.Generator().manual_seed(sum(name.encode()))
    return (torch.randn(1, frames, dim, generator=gen) * scale)[0].to(device)


def read_wav(path, to_rate: int) -> np.ndarray:
    """16-bit PCM WAV -> float32 mono at to_rate (polyphase resampling)."""
    from scipy.signal import resample_poly

    with wave.open(str(path), "rb") as f:
        rate, ch = f.getframerate(), f.getnchannels()
        pcm = np.frombuffer(f.readframes(-1), dtype=np.int16).astype(np.float32) / 32768.0
    if ch > 1:
        pcm = pcm.reshape(-1, ch).mean(axis=1)
    if rate != to_rate:
        g = math.gcd(rate, to_rate)
        pcm = resample_poly(pcm[None], to_rate // g, rate // g, axis=-1)[0]
    return pcm.astype(np.float32)


class Reference:
    """The model at the configuration's weight precision and numerics, or
    with `control` (a key of CONTROLS) one step below them."""

    def __init__(self, cfg: dict, seed: int, device, control: str | None = None):
        bits = 4 if control == "int4_weights" else 8
        W = serving_weights(make_params(cfg["model"], seed, device), cfg["serving"]["param_dtype"], bits)
        self.cfg, self.device = cfg, device
        numerics = Numerics(cfg, control)
        self.flow_lm, self.mimi = FlowLM(W, cfg["model"], numerics), Mimi(W, cfg["model"], numerics)
        self.W = W
        self.tokenizer = HashTokenizer(cfg["model"]["flow_lm"]["lookup_table"]["n_bins"])

    def voice_prompt(self, voice) -> torch.Tensor:
        """[P, E] conditioning of a predefined voice name or a WAV path."""
        v = self.cfg["voice"]
        if isinstance(voice, str) and not voice.endswith(".wav"):
            return synthetic_voice(voice, v["prompt_frames"], self.cfg["model"]["flow_lm"]["transformer"]["d_model"],
                                   v["prompt_scale"], self.device)
        wav = torch.from_numpy(read_wav(voice, self.cfg["model"]["mimi"]["sample_rate"])).to(self.device)
        return F.linear(self.mimi.encode(wav), self.W["flow_lm"]["speaker_proj_weight"])

    @torch.no_grad()
    def audio(self, voice, text: str, chunked: bool = True, alone: bool = False) -> np.ndarray:
        """The PCM of one request: each sentence chunk decoded from the voice
        afresh (chunked=False: the text as given is one chunk, as a batch
        takes it; alone: decoded by itself through the streaming API)."""
        prompt = self.voice_prompt(voice)
        parts = []
        for tokens in text_chunks(self.tokenizer, text) if chunked else [self.tokenizer.encode(text)]:
            frames = max_frames(len(tokens), self.cfg["model"]["mimi"]["frame_rate"])
            latents = self.flow_lm.generate(prompt, tokens, frames, alone)
            parts.append(self.mimi.decode(latents).cpu().numpy())
        return np.concatenate(parts)


def audio_gap(got: np.ndarray, ref: np.ndarray) -> float:
    """Largest sample difference over the reference's peak; a length
    mismatch is a gap of infinity."""
    if got.shape != ref.shape:
        return float("inf")
    return float(np.max(np.abs(got.astype(np.float64) - ref)) / max(float(np.max(np.abs(ref))), 1e-30))

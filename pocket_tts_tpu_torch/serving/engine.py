"""Continuous-batching TTS engine: many concurrent streams on one card
(port of pocket_tts_tpu/serving/engine.py).

The engine owns B decode *slots* whose state lives on the model's device:

  - FlowLM slot-major KV caches, the one `slot_pos` all layers share, and
    (int8 KV) the per-row scales                  (models/flow_lm.py)
  - Mimi streaming decode state                   (models/mimi.py)
  - the decode carry: per-slot BOS flag, step and EOS counters
                                                  (models/generate.py)

Each tick admits queued requests (one scatter per state leaf for all slots
of one voice, then one width-bucketed prefill of the batch, inactive slots
at length 0) and decodes one S-frame segment of every slot. Completed slots
are retired on the host from the segment's emit mask, one tick later under
pipelining, and are reusable at once. A stream may be *parked* (preempted)
into a device-resident store when a new arrival finds every slot busy, and
resumed or swapped back later.

The caches update in place (the JAX engine updates functionally and donates
its buffers): admission and resume copy rows out of the voice tree or the
store, never alias them. The write index `widx` and the stream positions are
host integers of the state tree; `_written` and `_pos` mirror them as the
JAX engine's host mirrors do. Every decode step attends over the whole cache
capacity, as the JAX engine's segment program does. On a card every batch
decode attention (slots > 1) goes through ops/batch_attention's CUDA kernel,
and one slot decodes through the B=1 kernels.

Left out on purpose, as compile or relay artifacts of the JAX engine: the
startup precompiles, padding of groups to compiled sizes, mesh placement,
and the host-side PRNG split (the engine owns a torch.Generator; the flow
noise of a segment is drawn as one [S, B, ldim] tensor).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from pocket_tts_tpu_torch.default_parameters import DEFAULT_SEGMENT_FRAMES, KV_CAPACITY_BUCKET, MAX_TOKEN_PER_CHUNK
from pocket_tts_tpu_torch.models.generate import initial_carry, run_segment
from pocket_tts_tpu_torch.models.text import estimate_max_gen_len, prepare_text_prompt, split_into_best_sentences
from pocket_tts_tpu_torch.models.tts_model import ModelState, TTSModel, _bucket
from pocket_tts_tpu_torch.ops.batch_attention import MAX_READ_ROWS
from pocket_tts_tpu_torch.ops.sampling import sample_noise
from pocket_tts_tpu_torch.utils.transfer import host_to_device

logger = logging.getLogger(__name__)

_EOS_NEVER = 2**30
_NOISE_SEED = 1234  # the JAX engine's PRNGKey
_CAPACITY_ALIGN = 32  # fused_backbone_step's cache row multiple (ops/fused_backbone.py)


class EngineOverloaded(RuntimeError):
    """Raised by submit() when the engine's pending backlog is full.

    Past saturation, queueing only turns every new request's time to first
    audio into unbounded wait, so the engine sheds load at the front door
    and says when to retry: `retry_after_s` estimates when a backlog's worth
    of work will have drained, from the recent completion rate. HTTP
    frontends answer 503 + Retry-After (serving/server.py)."""

    def __init__(self, retry_after_s: float):
        self.retry_after_s = float(retry_after_s)
        super().__init__(f"engine backlog full; retry after ~{self.retry_after_s:.1f}s")


@dataclass
class RequestHandle:
    """Consumer side of a submitted request: iterate frames() for audio."""

    request_id: int
    text: str
    # submit() time; with record_frame_times=True, frame_times[0] -
    # submit_time is this stream's time to first audio under load.
    submit_time: float = 0.0
    # Arrival time of every delivered frame (record_frame_times=True); feed
    # to TTSEngine.frame_lateness() to check playback deadlines.
    frame_times: list = field(default_factory=list)
    # Playback lead (always tracked; drives preemption): a player that
    # started at the first frame has consumed (now - _first_frame_time) s and
    # holds _frames_delivered * frame_seconds of audio.
    _first_frame_time: Optional[float] = None
    _frames_delivered: int = 0
    _queue: "queue.Queue[Optional[np.ndarray]]" = field(default_factory=queue.Queue)
    _done: threading.Event = field(default_factory=threading.Event)
    # Remaining sentence chunks of a long text; each restarts from the voice
    # state, like the direct API's per-chunk copy_state=True.
    _chunks: list = field(default_factory=list)
    _voice: Optional[ModelState] = None
    _cancelled: threading.Event = field(default_factory=threading.Event)

    def cancel(self) -> None:
        """Stop decoding this request (e.g. the client disconnected). Frames
        already queued stay readable; the stream ends at the next tick."""
        self._cancelled.set()

    def frames(self):
        """Yield 1920-sample frames (float32, or int16 with emit_pcm16) until
        the utterance completes."""
        while True:
            frame = self._queue.get()
            if frame is None:
                return
            yield frame

    def audio(self) -> np.ndarray:
        """Block until completion and return the full waveform."""
        chunks = list(self.frames())
        if not chunks:
            return np.zeros((0,), dtype=np.float32)
        return np.concatenate(chunks, axis=0)

    @property
    def done(self) -> bool:
        return self._done.is_set()


@dataclass
class _Slot:
    active: bool = False
    handle: Optional[RequestHandle] = None
    epoch: int = -1  # admission generation; guards stale pipelined deliveries
    frames_left: int = 0  # max_gen minus the frames dispatched so far


@dataclass
class _Parked:
    """A preempted stream parked in lane `lane` of the device-resident store
    (its compacted FlowLM rows, Mimi streaming state and mid-flight carry);
    the host keeps only these scalars."""

    handle: RequestHandle
    lane: int
    pos: int  # host mirror of the stream position
    valid: int  # upper bound on the row's valid KV entries (8-aligned)
    old_epoch: int  # epoch the stream held when parked (stale-delivery cleanup)
    frames_left: int  # the slot's frames_left when parked


# ---------------------------------------------------------------- row movers
#
# A state tree is nested dicts and lists whose per-row leaves are tensors
# with the slot (or lane) on dim 0; host ints and lists (widx, pos, tick) are
# batch-common and never move. A tensor that sits at several places of one
# tree (FlowLM's shared slot_pos) is read and written once, so it stays
# shared.


def _row_pairs(dst, src, seen: set):
    """(dst leaf, src leaf) for every per-row tensor of two trees of one
    structure, each dst tensor once."""
    if isinstance(dst, torch.Tensor):
        if id(dst) not in seen:
            seen.add(id(dst))
            yield dst, src
    elif isinstance(dst, dict):
        for key in dst:
            yield from _row_pairs(dst[key], src[key], seen)
    elif isinstance(dst, list):
        for a, b in zip(dst, src):
            yield from _row_pairs(a, b, seen)


def _take(tree, idx: torch.Tensor, memo: Optional[dict] = None):
    """A new tree holding rows `idx` of every per-row tensor (copies)."""
    memo = {} if memo is None else memo
    if isinstance(tree, torch.Tensor):
        if id(tree) not in memo:
            memo[id(tree)] = tree.index_select(0, idx)
        return memo[id(tree)]
    if isinstance(tree, dict):
        return {key: _take(leaf, idx, memo) for key, leaf in tree.items()}
    if isinstance(tree, list):
        return [_take(leaf, idx, memo) for leaf in tree]
    return tree


def _put(dst, src, idx: torch.Tensor) -> None:
    """Write the rows of `src` (K rows, or one row broadcast K ways) into
    rows `idx` of `dst`, in place."""
    K = idx.shape[0]
    for d, s in _row_pairs(dst, src, set()):
        s = s.to(d.dtype)
        if s.shape[0] != K:
            s = s.expand((K,) + tuple(s.shape[1:]))
        d.index_copy_(0, idx, s)


def _tensors(tree):
    """Every tensor of a state tree, each once."""
    for leaf, _ in _row_pairs(tree, tree, set()):
        yield leaf


def _ceil8(n: int) -> int:
    return -(-n // 8) * 8


class TTSEngine:
    """Slot-based continuous batching over the segment decode."""

    def __init__(
        self,
        model: TTSModel,
        slots: int = 8,
        segment_frames: int = DEFAULT_SEGMENT_FRAMES,
        capacity: int = 4096,
        text_pad: int = 64,
        warmup_frames: int = 1,
        emit_pcm16: bool = False,
        record_frame_times: bool = False,
        max_capacity: Optional[int] = None,
        first_segment_frames: int = 2,
        prefill_buckets: tuple = (16, 32),
        preempt: bool = True,
        max_parked: Optional[int] = None,
        preempt_min_lead_s: float = 0.35,
        resume_urgent_lead_s: float = 0.6,
        swap_margin_s: float = 0.5,
        max_swaps_per_tick: int = 4,
        max_pending: Optional[int] = None,
    ):
        self.model = model
        self.device = model.device
        self.num_slots = slots
        self.segment_frames = segment_frames
        # The B=1 kernels take caches of a multiple of 32 rows; the rows
        # added by rounding up are never valid.
        capacity = -(-capacity // _CAPACITY_ALIGN) * _CAPACITY_ALIGN
        self.capacity = capacity
        self.text_pad = text_pad
        # Prefill widths (ascending, ending in text_pad): an admission
        # prefills at the smallest width covering its longest text.
        self.prefill_buckets = tuple(sorted({w for w in prefill_buckets if 0 < w < text_pad} | {text_pad}))
        # A submit() whose KV need exceeds `capacity` is accepted and the
        # cache grows to the next bucket at a tick boundary, up to
        # max_capacity (default 4x, aligned down to the bucket grid).
        raw_max = 4 * capacity if max_capacity is None else max_capacity
        self.max_capacity = max(capacity, (raw_max // KV_CAPACITY_BUCKET) * KV_CAPACITY_BUCKET)
        if torch.device(self.device).type == "cuda" and slots > 1 and self.max_capacity > MAX_READ_ROWS:
            # Refused here, not on the tick that first grows past it.
            raise ValueError(f"max_capacity {self.max_capacity} exceeds the {MAX_READ_ROWS} cache rows that the batch "
                             "decode attention kernel reads on the card (ops/batch_attention.MAX_READ_ROWS)")
        self._target_capacity = capacity
        self.warmup_frames = warmup_frames
        self.emit_pcm16 = emit_pcm16
        self.record_frame_times = record_frame_times
        # Preemption: an arrival that finds every slot busy may park the
        # running stream with the most buffered playback lead and take its
        # slot; parked streams resume into freed slots, urgent first, or swap
        # with a running stream that holds swap_margin_s more lead.
        self.preempt = preempt
        self.max_parked = min(slots, 16) if max_parked is None else max_parked
        self.preempt_min_lead_s = preempt_min_lead_s
        self.resume_urgent_lead_s = resume_urgent_lead_s
        self.swap_margin_s = swap_margin_s
        self.max_swaps_per_tick = max_swaps_per_tick
        # Admission control: submit() raises EngineOverloaded once the
        # not-yet-admitted backlog reaches max_pending (None: unbounded).
        self.max_pending = max_pending
        self.rejected = 0
        self._completions: list = []  # recent completion times: the drain rate
        self.frame_seconds = 1.0 / float(model.config.mimi.frame_rate)

        flow_lm, mimi, dev = model.flow_lm, model.mimi, self.device
        B = slots
        self.flow_state = flow_lm.init_state(B, capacity, dtype=model.flow_state_dtype, device=dev)
        self.mimi_state = mimi.init_decode_state(B, model.state_dtype, segment_frames, dev)
        # max_gen = 0 marks a slot inactive (its emit is always off).
        self.carry = initial_carry(B, flow_lm.ldim, [0] * B, [0] * B, dev)
        self._written = 0  # host mirror of the batch-common write index
        self._pos = [0] * B  # host mirror of the active slots' stream positions
        self._warm_mimi_row = None  # warmed-up one-row Mimi state, copied into slots
        self._epoch_counter = 0
        self._retired_epochs: set[int] = set()
        self._voice_cache: dict = {}  # id(voice) -> (voice, capacity-expanded tree)

        self._slots = [_Slot() for _ in range(B)]
        self._parked: list[_Parked] = []
        self._parked_by_epoch: dict[int, _Parked] = {}
        # Observability.
        self.preemptions = 0  # parks, swaps included
        self.resumes = 0  # resumes, swaps included
        self.swaps = 0
        self.compactions = 0
        self.growths = 0
        self.frames_dispatched = 0  # decoded frames of all dispatched segments
        # Seconds per pipelined tick while any stream is active (run()).
        self.tick_walls: list = []
        if self.preempt:
            # Device-resident parking store: max_parked lanes of slot-shaped
            # state; all parks of a tick write it together, all resumes read it.
            P = self.max_parked
            self._store_flow = flow_lm.init_state(P, capacity, dtype=model.flow_state_dtype, device=dev)
            self._store_mimi = mimi.init_decode_state(P, model.state_dtype, segment_frames, dev)
            self._store_carry = initial_carry(P, flow_lm.ldim, [0] * P, [0] * P, dev)
            self._free_lanes = list(range(P))
        self._pending: "queue.Queue[tuple]" = queue.Queue()
        self._next_id = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        # Short segment for the tick right after an admission: new streams
        # reach their first frame after first_segment_frames of decode.
        self.first_segment_frames = max(1, min(first_segment_frames, segment_frames))
        self._just_admitted = False
        self._ticks_since_short = 1 << 30  # the first admission is always short
        self._deferred: list = []  # oversized items awaiting capacity growth
        # The engine's own noise stream: the model's generator stays with
        # the model's direct API, which other threads may call.
        self._gen = torch.Generator().manual_seed(_NOISE_SEED)

    # ------------------------------------------------------------ submission

    def submit(
        self,
        text: str,
        voice_state: ModelState,
        frames_after_eos: Optional[int] = None,
        max_tokens: int = MAX_TOKEN_PER_CHUNK,
    ) -> RequestHandle:
        """Queue an utterance; returns a handle streaming its frames.

        Long texts are split into sentence chunks (the direct API's packing);
        the handle's frames span all chunks in order. Raises EngineOverloaded
        (with a retry_after_s estimate) when max_pending is set and the
        not-yet-admitted backlog is full."""
        if self.max_pending is not None:
            backlog = self.backlog
            if backlog >= self.max_pending:
                self.rejected += 1
                raise EngineOverloaded(self._estimate_retry_after(backlog))
        max_tokens = min(max_tokens, self.text_pad)
        chunks = split_into_best_sentences(self.model.tokenizer, text, max_tokens)

        def chunk_specs(chunk_text: str):
            _, guess = prepare_text_prompt(chunk_text)
            fae = frames_after_eos if frames_after_eos is not None else guess + 2
            tokens = self.model.tokenizer.encode(chunk_text)
            # The splitter never cuts inside a sentence: hard-split a token
            # list longer than the prefill width rather than truncate it.
            for start in range(0, len(tokens), self.text_pad):
                part = tokens[start : start + self.text_pad]
                max_gen = estimate_max_gen_len(
                    len(part), self.model.config.mimi.frame_rate,
                    self.model._TOKENS_PER_SECOND_ESTIMATE, self.model._GEN_SECONDS_PADDING,
                )
                yield (fae, max_gen, part)

        specs = [spec for c in chunks for spec in chunk_specs(c)]
        # Every chunk restarts from the voice prompt: the slot needs room for
        # the voice rows, one prefill and the longest chunk's frames.
        worst = max(voice_state.written + self.text_pad + max_gen + 2 * self.segment_frames
                    for _, max_gen, _ in specs)
        if worst > self.max_capacity:
            raise ValueError(
                f"request needs ~{worst} KV slots but the engine's max_capacity is {self.max_capacity}; "
                "raise TTSEngine(max_capacity=...) or shorten the voice prompt"
            )
        if worst > self.capacity:
            # Grow at the next tick boundary (_maybe_grow); the request
            # stays queued until the cache can hold it.
            with self._lock:
                self._target_capacity = max(self._target_capacity, min(_bucket(worst), self.max_capacity))
        with self._lock:
            handle = RequestHandle(self._next_id, text, submit_time=time.monotonic())
            self._next_id += 1
        handle._voice = voice_state
        handle._chunks = specs[1:]
        fae, max_gen, tokens = specs[0]
        self._pending.put((handle, voice_state, fae, max_gen, tokens))
        return handle

    # ----------------------------------------------------- admission control

    @property
    def backlog(self) -> int:
        """Requests accepted but not yet decoding: queued + growth-deferred
        (chunk continuations of admitted requests count too)."""
        return self._pending.qsize() + len(self._deferred)

    def _record_completion(self) -> None:
        self._completions.append(time.monotonic())
        if len(self._completions) > 256:
            del self._completions[:128]

    def _estimate_retry_after(self, backlog: int) -> float:
        """Seconds until about one backlog's worth of work drains, from the
        recent completion rate (1 s without history), within [0.5, 30]."""
        now = time.monotonic()
        recent = [t for t in self._completions[-64:] if now - t < 30.0]
        if len(recent) >= 2 and now > recent[0]:
            rate = len(recent) / (now - recent[0])
            est = (backlog - self.num_slots + 1) / max(rate, 1e-3)
        else:
            est = 1.0
        return float(min(max(est, 0.5), 30.0))

    # ------------------------------------------------------------ helpers

    def _index(self, values: list[int]) -> torch.Tensor:
        """Slot or lane indices as a device tensor, queued without a sync."""
        return host_to_device(torch.tensor(values, dtype=torch.long), self.device)

    def _expanded_voice(self, voice_state: ModelState) -> dict:
        """Voice tree padded to the engine capacity (cached; the entry holds
        the ModelState so its id() cannot be recycled). Admission copies
        rows out of it and never writes it."""
        key = id(voice_state)
        hit = self._voice_cache.get(key)
        if hit is None or hit[0] is not voice_state:
            tree = self.model.flow_lm.expand_state(voice_state.tree, self.capacity)
            if len(self._voice_cache) >= 16:
                self._voice_cache.pop(next(iter(self._voice_cache)))
            hit = (voice_state, tree)
            self._voice_cache[key] = hit
        return hit[1]

    def _warm_mimi(self) -> dict:
        """One-row Mimi state after the zero-latent warmup (deterministic and
        voice-independent: computed once, copied into every admitted slot)."""
        if self._warm_mimi_row is None:
            self._warm_mimi_row = self.model._warm_mimi_state(1, self.segment_frames, self.warmup_frames)
        return self._warm_mimi_row

    def _lead(self, handle: RequestHandle, now: float) -> Optional[float]:
        """Seconds of audio the stream's player holds beyond its playhead;
        None until the first frame (such a stream is never preempted)."""
        t0 = handle._first_frame_time
        if t0 is None:
            return None
        return handle._frames_delivered * self.frame_seconds - (now - t0)

    @staticmethod
    def _finish(handle: RequestHandle) -> None:
        handle._chunks.clear()
        if not handle.done:
            handle._queue.put(None)
            handle._done.set()

    # ------------------------------------------------------------ admission

    def _admit_group(self, items: list) -> list:
        """Copy the voice rows of a group of admissions into their slots: one
        scatter per state leaf for all slots of one voice.

        items: [(b, handle, voice_state, fae, max_gen, tokens)]. Returns
        [(b, tokens)] for the batched prefill."""
        warm = self._warm_mimi()
        admitted = []
        by_voice: dict[int, list] = {}
        for it in items:
            by_voice.setdefault(id(it[2]), []).append(it)
        tstate = self.flow_state["transformer"]
        for group in by_voice.values():
            voice_state = group[0][2]
            # The batch write index must clear the voice's own rows, or the
            # next prefill would overwrite them.
            self._written = max(self._written, voice_state.written)
            slots = [b for b, *_ in group]
            idx = self._index(slots)
            _put(tstate, self._expanded_voice(voice_state)["transformer"], idx)
            tstate["widx"] = max(tstate["widx"], self._written)
            for b in slots:
                self.flow_state["pos"][b] = voice_state.pos[0]
            _put(self.mimi_state, warm, idx)
            carry = self.carry
            carry["latent"].index_fill_(0, idx, 0.0)
            carry["is_bos"].index_fill_(0, idx, True)
            carry["eos_step"].index_fill_(0, idx, _EOS_NEVER)
            carry["step"].index_fill_(0, idx, 0)
            counts = host_to_device(torch.tensor([[it[3] for it in group], [it[4] for it in group]]), self.device)
            carry["frames_after_eos"].index_copy_(0, idx, counts[0].to(carry["frames_after_eos"].dtype))
            carry["max_gen"].index_copy_(0, idx, counts[1].to(carry["max_gen"].dtype))
            for b, handle, voice, fae, max_gen, tokens in group:
                self._pos[b] = voice.pos[0]
                slot = self._slots[b]
                slot.active, slot.handle, slot.frames_left = True, handle, max_gen
                self._epoch_counter += 1
                slot.epoch = self._epoch_counter
                logger.info("engine: admitted request %d into slot %d", handle.request_id, b)
                admitted.append((b, tokens))
        return admitted

    def _prefill_admitted(self, admitted: list[tuple[int, list[int]]]) -> None:
        """One batched prefill for all newly admitted slots (others at
        length 0, which write only invalid rows), at the smallest bucketed
        width that holds the longest text."""
        B = self.num_slots
        longest = max((len(toks) for _, toks in admitted), default=0)
        width = next(w for w in self.prefill_buckets if w >= min(longest, self.text_pad))
        tokens = torch.zeros(B, width, dtype=torch.long)
        lengths = [0] * B
        for b, toks in admitted:
            toks = toks[:width]
            tokens[b, : len(toks)] = torch.tensor(toks, dtype=torch.long)
            lengths[b] = len(toks)
            self._pos[b] += len(toks)
        fl, flow_params = self.model.flow_lm, self.model.params["flow_lm"]
        emb = fl.embed_text(flow_params, host_to_device(tokens, self.device))
        self.flow_state = fl.prefill(flow_params, self.flow_state, emb, lengths)
        self._written += width

    # ------------------------------------------------------------ preemption

    def _execute_parks(self, plan: list[tuple[int, float]]) -> None:
        """Park the planned victim slots into free lanes, all at once: their
        FlowLM rows compacted to the row front (resuming is then the
        admission contract, widx >= valid), Mimi state and carry as they are.
        plan: [(slot, lead)]; the caller guarantees a free lane each."""
        lanes = [self._free_lanes.pop() for _ in plan]
        slots = [b for b, _ in plan]
        src, dst = self._index(slots), self._index(lanes)
        rows = self.model.flow_lm.compact_state(_take(self.flow_state, src), 0)
        _put(self._store_flow, rows, dst)
        _put(self._store_mimi, _take(self.mimi_state, src), dst)
        _put(self._store_carry, _take(self.carry, src), dst)
        for (b, lead), lane in zip(plan, lanes):
            slot = self._slots[b]
            parked = _Parked(handle=slot.handle, lane=lane, pos=self._pos[b],
                             valid=min(_ceil8(self._pos[b] + 1), self.capacity), old_epoch=slot.epoch,
                             frames_left=slot.frames_left)
            self._parked.append(parked)
            self._parked_by_epoch[slot.epoch] = parked
            self.preemptions += 1
            logger.info("engine: parked request %d from slot %d into lane %d (lead %.2f s)",
                        slot.handle.request_id, b, lane, lead)
            slot.active = False
            slot.handle = None

    def _drop_parked(self, parked: _Parked) -> None:
        self._parked.remove(parked)
        self._parked_by_epoch.pop(parked.old_epoch, None)
        self._free_lanes.append(parked.lane)

    def _live(self, plan: list) -> list:
        """The planned moves whose parked stream is still parked; a stream
        cancelled while parked is finished for free."""
        live = []
        for move in plan:
            parked = move[0]
            if parked not in self._parked:
                continue  # dropped: retired in a stale in-flight segment
            if parked.handle._cancelled.is_set():
                self._drop_parked(parked)
                self._finish(parked.handle)
                continue
            live.append(move)
        return live

    def _restore(self, parked: _Parked, b: int) -> None:
        """Host bookkeeping of a parked stream entering slot b."""
        self._pos[b] = parked.pos
        self.flow_state["pos"][b] = parked.pos
        slot = self._slots[b]
        slot.active, slot.handle, slot.frames_left = True, parked.handle, parked.frames_left
        self._epoch_counter += 1
        slot.epoch = self._epoch_counter
        self.resumes += 1

    def _execute_resumes(self, plan: list[tuple[_Parked, int]]) -> bool:
        """Copy the planned parked lanes back into their slots, all at once:
        the mirror of admission, with the streams' own Mimi state and
        mid-flight carry."""
        live = self._live(plan)
        if not live:
            return False
        src, dst = self._index([p.lane for p, _ in live]), self._index([b for _, b in live])
        widx_new = max(p.valid for p, _ in live)
        tstate = self.flow_state["transformer"]
        _put(tstate, _take(self._store_flow, src)["transformer"], dst)
        # Resumed rows hold entries in [0, valid): the write index clears them.
        tstate["widx"] = max(tstate["widx"], widx_new)
        _put(self.mimi_state, _take(self._store_mimi, src), dst)
        _put(self.carry, _take(self._store_carry, src), dst)
        self._written = max(self._written, widx_new)
        for parked, b in live:
            self._drop_parked(parked)
            self._restore(parked, b)
            logger.info("engine: resumed request %d into slot %d", parked.handle.request_id, b)
        return True

    def _execute_swaps(self, plan: list[tuple[_Parked, int, float]]) -> bool:
        """Exchange the planned victim slots' state with parked lanes' state:
        a park and a resume fused, so no free lane is needed. Both sides are
        read (copied) before either is written. plan: [(parked, slot,
        victim_lead)]."""
        live = self._live(plan)
        if not live:
            return False
        lanes, slots = self._index([p.lane for p, _, _ in live]), self._index([b for _, b, _ in live])
        victims_flow = self.model.flow_lm.compact_state(_take(self.flow_state, slots), 0)
        victims_mimi, victims_carry = _take(self.mimi_state, slots), _take(self.carry, slots)
        rows_flow = _take(self._store_flow, lanes)
        rows_mimi, rows_carry = _take(self._store_mimi, lanes), _take(self._store_carry, lanes)
        _put(self._store_flow, victims_flow, lanes)
        _put(self._store_mimi, victims_mimi, lanes)
        _put(self._store_carry, victims_carry, lanes)
        widx_new = max(p.valid for p, _, _ in live)
        tstate = self.flow_state["transformer"]
        _put(tstate, rows_flow["transformer"], slots)
        tstate["widx"] = max(tstate["widx"], widx_new)
        _put(self.mimi_state, rows_mimi, slots)
        _put(self.carry, rows_carry, slots)
        self._written = max(self._written, widx_new)
        for parked, b, lead in live:
            slot = self._slots[b]
            victim = _Parked(handle=slot.handle, lane=parked.lane, pos=self._pos[b],
                             valid=min(_ceil8(self._pos[b] + 1), self.capacity), old_epoch=slot.epoch,
                             frames_left=slot.frames_left)
            self._parked.remove(parked)
            self._parked_by_epoch.pop(parked.old_epoch, None)
            self._parked.append(victim)
            self._parked_by_epoch[victim.old_epoch] = victim
            self._restore(parked, b)
            self.preemptions += 1
            self.swaps += 1
            logger.info("engine: swapped request %d (lead %.2f s) out of slot %d for parked request %d (lane %d)",
                        victim.handle.request_id, lead, b, parked.handle.request_id, parked.lane)
        return True

    def _preemptable(self, slot: _Slot) -> bool:
        """An active slot whose stream still has frames to decode. A stream
        whose dispatched frames reached max_gen ends at its next delivery
        (the one-tick retirement lag); parking it would only be undone."""
        return slot.active and slot.frames_left > 0

    def _pick_victims(self, want: int, now: float, exclude: set) -> list[int]:
        """Slots safe to preempt, most playback lead first: a victim has
        delivered its first frame and holds more than preempt_min_lead_s of
        lead, so pausing it cannot stall its player before it resumes."""
        scored = []
        for b, slot in enumerate(self._slots):
            if not self._preemptable(slot) or b in exclude:
                continue
            lead = self._lead(slot.handle, now)
            if lead is not None and lead > self.preempt_min_lead_s:
                scored.append((lead, b))
        scored.sort(reverse=True)
        return [b for _, b in scored[:want]]

    def _sweep_parked(self) -> None:
        """Finish parked streams whose client cancelled while they waited."""
        for parked in list(self._parked):
            if parked.handle._cancelled.is_set():
                self._drop_parked(parked)
                self._finish(parked.handle)

    # ------------------------------------------------------------ growth and compaction

    def _maybe_grow(self) -> None:
        """Expand the KV cache (and the parking store, whose rows sit
        compacted at the row front) to the pending target capacity, at a tick
        boundary, then reclaim dead rows if that lowers the write index."""
        with self._lock:
            target = self._target_capacity
        if target <= self.capacity:
            return
        logger.info("engine: growing KV capacity %d -> %d", self.capacity, target)
        fl = self.model.flow_lm
        self.flow_state = fl.expand_state(self.flow_state, target)
        if self.preempt:
            self._store_flow = fl.expand_state(self._store_flow, target)
        self.capacity = target
        self._voice_cache.clear()  # cached voices are padded to the old size
        self.growths += 1
        max_valid = _ceil8(max(self._pos) + 1)
        if max_valid < self._written:
            self._compact(max_valid)

    def _compact(self, new_written: int) -> None:
        self.flow_state = self.model.flow_lm.compact_state(self.flow_state, new_written)
        self._written = new_written
        self.compactions += 1

    def _maybe_compact(self) -> None:
        """Gather each slot's valid cache rows to the row front when the
        shared write index nears capacity."""
        budget = self.text_pad + 4 * self.segment_frames
        if self._written + budget < self.capacity:
            return
        logger.info("engine: compacting KV cache (written=%d)", self._written)
        self._compact(_ceil8(max(self._pos) + 1))

    # ------------------------------------------------------------ main loop

    def _admit_pending(self, block_seconds: float = 0.0) -> bool:
        """Admit queued requests; returns True if slot contents changed.

        Slot assignment within a tick: (1) urgent parked streams (lead below
        resume_urgent_lead_s) take free slots first, or swap with a running
        stream holding swap_margin_s more lead; (2) pending requests take the
        remaining free slots, and past those preempt the running streams
        with the most lead; (3) other parked streams fill what is left. The
        tick plans every move first, then runs one group park, one group
        swap, one group admission (+ one prefill) and one group resume.

        With block_seconds > 0 the first fetch blocks briefly (the idle run
        loop's wait)."""
        self._maybe_grow()
        self._sweep_parked()
        now = time.monotonic()
        free = [b for b, s in enumerate(self._slots) if not s.active]
        touched: set = set()  # slots (re)filled this tick: not preemptable
        plan_park: list[tuple[int, float]] = []
        plan_resume: list[tuple[_Parked, int]] = []
        plan_swap: list[tuple[_Parked, int, float]] = []
        planned: set = set()  # id(parked) planned for resume or swap

        if self._parked:
            urgent = sorted(
                (p for p in self._parked if (self._lead(p.handle, now) or 0.0) < self.resume_urgent_lead_s),
                key=lambda p: self._lead(p.handle, now) or 0.0,
            )
            for parked in urgent:
                if not free:
                    break
                b = free.pop(0)
                plan_resume.append((parked, b))
                planned.add(id(parked))
                touched.add(b)
            swaps = 0
            for parked in urgent:
                if id(parked) in planned or swaps >= self.max_swaps_per_tick:
                    continue
                p_lead = self._lead(parked.handle, now) or 0.0
                best_b, best_lead = None, p_lead + self.swap_margin_s
                for b, slot in enumerate(self._slots):
                    if not self._preemptable(slot) or b in touched:
                        continue
                    lead = self._lead(slot.handle, now)
                    if lead is not None and lead > best_lead:
                        best_b, best_lead = b, lead
                if best_b is None:
                    continue
                plan_swap.append((parked, best_b, best_lead))
                planned.add(id(parked))
                touched.add(best_b)
                swaps += 1

        # Lanes still free bound how many victims this tick may park.
        preempt_budget = len(self._free_lanes) if self.preempt else 0

        admissible, deferred = [], []
        candidates = self._deferred
        self._deferred = []
        first = True
        while len(admissible) < len(free) + preempt_budget:
            if candidates:
                item = candidates.pop(0)
            else:
                try:
                    if first and block_seconds > 0 and not plan_resume:
                        item = self._pending.get(timeout=block_seconds)
                    else:
                        item = self._pending.get_nowait()
                except queue.Empty:
                    break
                first = False
            handle, voice, fae, max_gen, tokens = item
            if handle._cancelled.is_set():
                self._finish(handle)  # the client gave up while queued
                continue
            need = voice.written + self.text_pad + max_gen + 2 * self.segment_frames
            if need > self.capacity:
                # Oversized for the current cache (a submit racing this
                # tick's growth): wait for the next tick's growth.
                with self._lock:
                    self._target_capacity = max(self._target_capacity, min(_bucket(need), self.max_capacity))
                deferred.append(item)
                continue
            admissible.append(item)

        # Victims for the shortfall; what still has no slot waits.
        shortfall = min(len(admissible) - len(free), preempt_budget)
        if shortfall > 0:
            exclude = touched | {b for b, _ in plan_park}
            for b in self._pick_victims(shortfall, now, exclude):
                plan_park.append((b, self._lead(self._slots[b].handle, now)))
                free.append(b)
        overflow = []
        while len(admissible) > len(free):
            overflow.append(admissible.pop())
        overflow.reverse()
        self._deferred = deferred + overflow + candidates

        # Execute: park -> swap -> admit (+ prefill) -> resume; the slot and
        # lane sets of the phases are disjoint.
        if plan_park:
            self._execute_parks(plan_park)
        swapped_any = self._execute_swaps(plan_swap) if plan_swap else False

        admitted_any = False
        if admissible:
            to_admit = [(b, *item) for b, item in zip(free, admissible)]
            touched.update(b for b, *_ in to_admit)
            free = free[len(admissible) :]
            admitted = self._admit_group(to_admit)
            self._maybe_compact()
            self._prefill_admitted(admitted)
            admitted_any = True

        for parked in list(self._parked):
            if not free:
                break
            if id(parked) in planned:
                continue
            b = free.pop(0)
            plan_resume.append((parked, b))
            planned.add(id(parked))
            touched.add(b)
        resumed_any = self._execute_resumes(plan_resume) if plan_resume else False

        # At most one short post-admission tick per 4 ticks: under sustained
        # churn it must not become the steady state.
        if admitted_any and self._ticks_since_short >= 4:
            self._just_admitted = True
        return admitted_any or resumed_any or swapped_any

    def _retire_epoch(self, epoch: int) -> None:
        self._retired_epochs.add(epoch)
        if len(self._retired_epochs) > 4 * self.num_slots:
            horizon = self._epoch_counter - 2 * self.num_slots
            self._retired_epochs = {e for e in self._retired_epochs if e > horizon}

    def _to_host(self, tensors: list[torch.Tensor]):
        """Queue device->host copies of `tensors` into pinned buffers and
        record an event that _deliver waits on: no host sync at dispatch.
        On the CPU the tensors are the host copies."""
        if self.device.type != "cuda":
            return tensors, None
        out = []
        for t in tensors:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            out.append(host)
        event = torch.cuda.Event()
        event.record()
        return out, event

    def _dispatch_segment(self):
        """Queue one decode segment of every slot on the device; returns what
        _deliver needs. Reads nothing back from the device, so a caller may
        dispatch the next segment before delivering this one (run())."""
        self._maybe_compact()
        if self._just_admitted:
            frames = self.first_segment_frames
            self._just_admitted = False
            self._ticks_since_short = 0
        else:
            frames = self.segment_frames
            self._ticks_since_short += 1
        model, B = self.model, self.num_slots
        noise = sample_noise(self._gen, (frames, B, model.flow_lm.ldim), model.temp, model.noise_clamp, self.device)
        self.flow_state, self.mimi_state, self.carry, audio, emit, _ = run_segment(
            model.flow_lm, model.mimi, model.params, self.flow_state, self.mimi_state, self.carry, noise,
            model.lsd_decode_steps, model.eos_threshold, emit_pcm16=self.emit_pcm16,
        )
        self._written += frames
        self.frames_dispatched += frames
        # Slot ownership at dispatch time: delivery touches only the (slot,
        # handle, epoch) triples that decoded in THIS segment.
        rows = [(b, s.handle, s.epoch) for b, s in enumerate(self._slots) if s.active]
        for b, _, _ in rows:
            self._pos[b] += frames
            self._slots[b].frames_left -= frames
        # At partial occupancy only the active rows' audio leaves the device.
        fetch_rows = None
        if len(rows) < B:
            idx = self._index([b for b, _, _ in rows])
            audio, emit = audio.index_select(0, idx), emit.index_select(0, idx)
            fetch_rows = rows
        # Snapshot of the carry fields delivery reads: frames_after_eos and
        # max_gen are written in place by later admissions and cancellations.
        c = self.carry
        counters = torch.stack([c["eos_step"], c["step"], c["frames_after_eos"].to(c["step"].dtype),
                                c["max_gen"].to(c["step"].dtype)])
        host, event = self._to_host([audio, emit, counters])
        return rows, fetch_rows, host, event

    def _deliver(self, dispatched) -> int:
        """Wait for a dispatched segment's outputs, push frames, retire slots."""
        rows, fetch_rows, host, event = dispatched
        if event is not None:
            event.synchronize()
        audio_np, emit_np, counters = (t.numpy() for t in host)
        eos_step, step, fae_np, max_gen_np = counters
        for i, (b, handle, epoch) in enumerate(rows):
            r = i if fetch_rows is not None else b
            if epoch in self._retired_epochs:
                # A stale segment of a retired admission: after a
                # cancellation it may carry frames that must not land after
                # the terminator.
                continue
            if handle._cancelled.is_set():
                self._retire_epoch(epoch)
                self._finish(handle)
                slot = self._slots[b]
                if slot.epoch == epoch:
                    slot.active = False
                    slot.handle = None
                    self.carry["max_gen"][b] = 0  # the still-running decode emits nothing
                continue
            now = time.monotonic()
            for s in range(emit_np.shape[1]):
                if emit_np[r, s]:
                    handle._queue.put(audio_np[r, s])
                    handle._frames_delivered += 1
                    if handle._first_frame_time is None:
                        handle._first_frame_time = now
                    if self.record_frame_times:
                        handle.frame_times.append(now)
            # Done when the reference loop would have exited
            # (step >= eos_step + frames_after_eos, capped by max_gen).
            if int(step[b]) >= min(int(eos_step[b]) + int(fae_np[b]), int(max_gen_np[b])):
                self._retire_epoch(epoch)
                if epoch in self._parked_by_epoch:
                    # Completed in the segment in flight when it was parked:
                    # its parked row is dead.
                    self._drop_parked(self._parked_by_epoch[epoch])
                if handle._chunks:
                    fae, max_gen, tokens = handle._chunks.pop(0)
                    self._pending.put((handle, handle._voice, fae, max_gen, tokens))
                else:
                    handle._queue.put(None)
                    handle._done.set()
                    self._record_completion()
                slot = self._slots[b]
                if slot.epoch == epoch:  # not yet re-admitted
                    slot.active = False
                    slot.handle = None
        return sum(s.active for s in self._slots)

    @torch.no_grad()
    def step(self) -> int:
        """Admit, decode one segment, deliver its frames (synchronous tick)."""
        self._admit_pending()
        if not any(s.active for s in self._slots):
            return 0
        return self._deliver(self._dispatch_segment())

    @torch.no_grad()
    def run(self, stop_when_idle: bool = True, max_ticks: Optional[int] = None) -> None:
        """Pump the engine until all submitted work is done (or forever, or
        until stop(), or for max_ticks decode ticks).

        Pipelined: segment k+1 is queued before segment k's outputs are read,
        so the device decodes while the host delivers frames. Retirement lags
        one segment; admission rewrites a slot's rows, so that is safe."""
        in_flight = None
        idle_ticks = 0
        ticks = 0
        tick_t0 = None
        while not self._stop.is_set():
            fully_idle = in_flight is None and not any(s.active for s in self._slots)
            now = time.monotonic()
            if tick_t0 is not None and not fully_idle:
                self.tick_walls.append(now - tick_t0)
                if len(self.tick_walls) > 4096:
                    del self.tick_walls[:2048]
            tick_t0 = None if fully_idle else now
            self._admit_pending(block_seconds=0.05 if fully_idle else 0.0)
            short_tick = self._just_admitted  # consumed by _dispatch_segment
            any_active = any(s.active for s in self._slots)
            dispatched = self._dispatch_segment() if any_active else None
            if in_flight is not None:
                self._deliver(in_flight)
            if dispatched is not None and short_tick:
                # The tick after an admission carries the new streams' first
                # frames: deliver it now rather than one tick later.
                self._deliver(dispatched)
                dispatched = None
            in_flight = dispatched
            ticks += any_active
            if max_ticks is not None and ticks >= max_ticks:
                break
            if (not any_active and in_flight is None and self._pending.empty() and not self._deferred
                    and not self._parked):
                idle_ticks += 1
                if stop_when_idle and idle_ticks > 1:
                    break
            else:
                idle_ticks = 0
        if in_flight is not None:
            self._deliver(in_flight)
        self._stop.clear()

    def stop(self) -> None:
        """Make the running (or the next) run() return at its next tick, with
        nothing in flight (ends serve_forever_in_thread's loop)."""
        self._stop.set()

    def frame_lateness(self, handle: RequestHandle, frame_seconds: float = 0.08) -> np.ndarray:
        """Per-frame playback lateness of one completed stream: playback
        starts at frame 0's arrival, so frame i is due at t0 + i *
        frame_seconds; returns arrival - deadline in seconds (positive: a
        player with no buffer would stall). Needs record_frame_times=True."""
        times = handle.frame_times
        if not times:
            return np.zeros((0,), dtype=np.float64)
        deadlines = times[0] + frame_seconds * np.arange(len(times))
        return np.asarray(times) - deadlines

    def serve_forever_in_thread(self) -> threading.Thread:
        """Run the engine loop on a daemon thread (for server frontends)."""
        thread = threading.Thread(target=self.run, kwargs={"stop_when_idle": False}, daemon=True)
        thread.start()
        return thread

    def state_tensors(self):
        """Every tensor of the engine's decode state and parking store (for
        checks that they live on the model's device)."""
        trees = [self.flow_state, self.mimi_state, self.carry]
        if self.preempt:
            trees += [self._store_flow, self._store_mimi, self._store_carry]
        for tree in trees:
            yield from _tensors(tree)

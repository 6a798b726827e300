"""Continuous-batching TTS engine: many concurrent streams on one card or on
a (dp, tp) mesh (port of pocket_tts_tpu/serving/engine.py).

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

The host side (the controller: submit, the queues, the slots' bookkeeping
and every decision that reads the clock) records each tick's device work as
a *plan*: growth, parks, swaps, admissions, compactions, the prefill,
resumes, cancellations and the segment, in order. `_flush` runs the plan on
the engine's state (the executor) before the tick's deliveries.

On a mesh (a model from `load_model(mesh=...)`; parallel/) the JAX engine's
single controller becomes rank 0. Every rank builds the engine (a
collective call) and holds its dp slice of the slots (parallel/mesh.dp_range;
all of them where dp does not divide `slots`) and its tp heads, and the whole
parking store on its heads (lanes replicated over dp, as the JAX engine
places it): a park or swap sends the parked rows from the rank that holds
the slot to its dp group, so a stream parked on one dp rank resumes on any.
Rank 0 alone takes submit() and cancellations and plans; its step() and
run() broadcast each tick's plan to the world (`broadcast:world` in
mesh.counts), and on every other rank step() and run() apply the plans they
receive until rank 0's run() or stop() ends them. Every rank then runs the
prefill, the Mimi warmup and each decode step in the same order, so their
tp collectives line up, draws each segment's noise at the whole [S, B,
ldim] shape from the engine's generator and keeps its rows, and gathers
each delivered segment's outputs over dp. A plan names a voice by its
ModelState.key, which every rank resolves; the HTTP server's voices are made
on every rank as plan items (voice_state).

The caches update in place (the JAX engine updates functionally and donates
its buffers): admission and resume copy rows out of the voice tree or the
store, never alias them. The write index `widx` and the stream positions are
host integers of the state tree; `_written` and `_pos` mirror them as the
JAX engine's host mirrors do. Every decode step attends over the whole cache
capacity, as the JAX engine's segment program does. On a card every batch
decode attention (slots > 1, or any slot on a mesh) goes through
ops/batch_attention's CUDA kernel, and one slot off a mesh decodes through
the B=1 kernels. Off a mesh, slots > 1 decode on the card by replaying the
model's captured step (models/step_graph.py), bound to the FlowLM caches:
compaction rewrites them in place, so only growth captures anew.

With the span recorder on (utils/trace.py), each tick of run() or step()
is an `engine.tick` span holding `engine.admit` (planning), `engine.apply`
(enqueuing the plan, one `engine.op.<op>` child per item), `engine.fetch`
(waiting on the device for a segment's outputs) and `engine.deliver`;
`RequestHandle.admit_time` dates each request's admission.

Left out on purpose, as compile or relay artifacts of the JAX engine: the
startup precompiles, padding of groups to compiled sizes, and the host-side
PRNG split (the engine owns a torch.Generator; the flow noise of a segment
is drawn as one [S, B, ldim] tensor).
"""

from __future__ import annotations

import collections
import logging
import queue
import threading
import time
import weakref
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
from pocket_tts_tpu_torch.parallel.collectives import all_gather_dp, all_gather_dp_tensor, broadcast_from_rank0
from pocket_tts_tpu_torch.parallel.mesh import dp_range
from pocket_tts_tpu_torch.utils import trace
from pocket_tts_tpu_torch.utils.transfer import host_to_device

logger = logging.getLogger(__name__)

# The span of each plan item, named once: a recorder that is off then costs
# a dict read per item.
_OP_SPANS = {op: f"engine.op.{op}" for op in
             ("voice", "grow", "compact", "park", "swap", "resume", "admit", "prefill", "cancel", "segment")}

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
    # When its first chunk was planned into a slot (time.monotonic(), the
    # clock of submit_time); admit_time - submit_time is its queue wait.
    # None until then.
    admit_time: Optional[float] = None
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


@dataclass
class _NamedVoice:
    """A predefined voice asked for by name (voice_state): made once, on a
    mesh on every rank as a plan item; `ready` is set when it is made (or
    when making it failed: `error`)."""

    state: Optional[ModelState] = None
    error: Optional[BaseException] = None
    ready: threading.Event = field(default_factory=threading.Event)


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


def _share_rows(mesh, trees: list, owners: list[int]) -> None:
    """Make row k of every tensor of `trees` (K rows each, on every rank of
    a dp group) the row of dp rank owners[k], in place: the rows' bytes in
    one [K, bytes] tensor, one all_gather over dp."""
    leaves = [t for tree in trees for t in _tensors(tree)]
    K = len(owners)
    flat = torch.cat([t.reshape(K, -1).view(torch.uint8) for t in leaves], dim=1)
    parts = all_gather_dp_tensor(mesh, flat)
    whole = torch.stack([parts[d][k] for k, d in enumerate(owners)])
    offset = 0
    for t in leaves:
        n = t.numel() // K * t.element_size()
        part = torch.empty((K, n), dtype=torch.uint8, device=t.device).copy_(whole[:, offset : offset + n])
        t.copy_(part.reshape(-1).view(t.dtype).reshape(t.shape))
        offset += n


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
        # Short segment for the tick right after an admission: new streams
        # reach their first frame after first_segment_frames of decode.
        self.first_segment_frames = max(1, min(first_segment_frames, segment_frames))

        # The mesh: rank 0 plans (the leader); this rank holds slots [lo, hi).
        self.mesh = model.mesh
        self._leader = self.mesh is None or self.mesh.rank == 0
        self._lo, self._hi = dp_range(self.mesh, slots)
        self._sharded = (self._lo, self._hi) != (0, slots)
        if self.mesh is not None:
            settings = (slots, segment_frames, capacity, text_pad, warmup_frames, emit_pcm16, self.max_capacity,
                        self.first_segment_frames, self.prefill_buckets, preempt, self.max_parked)
            if broadcast_from_rank0(self.mesh, settings) != settings:
                raise ValueError(f"rank {self.mesh.rank} built TTSEngine with other settings than rank 0: every rank "
                                 "of a mesh builds the same engine")

        # ---- the executor's state: this rank's rows, on the device
        flow_lm, mimi, dev = model.flow_lm, model.mimi, self.device
        B = self._hi - self._lo
        self.flow_state = flow_lm.init_state(B, capacity, dtype=model.flow_state_dtype, device=dev)
        self.mimi_state = mimi.init_decode_state(B, model.state_dtype, segment_frames, dev)
        # max_gen = 0 marks a slot inactive (its emit is always off).
        self.carry = initial_carry(B, flow_lm.ldim, [0] * B, [0] * B, dev)
        if self.preempt:
            # Device-resident parking store: max_parked lanes of slot-shaped
            # state (every lane on every rank, this rank's heads); all parks
            # of a tick write it together, all resumes read it.
            P = self.max_parked
            self._store_flow = flow_lm.init_state(P, capacity, dtype=model.flow_state_dtype, device=dev)
            self._store_mimi = mimi.init_decode_state(P, model.state_dtype, segment_frames, dev)
            self._store_carry = initial_carry(P, flow_lm.ldim, [0] * P, [0] * P, dev)
        self._warm_mimi_row = None  # warmed-up one-row Mimi state, copied into slots
        self._voice_cache: dict = {}  # voice key -> (voice, capacity-expanded tree)
        self._outputs: collections.deque = collections.deque()  # dispatched segments' outputs, oldest first
        # The engine's own noise stream (the same on every rank): the model's
        # generator stays with the model's direct API, which other threads
        # may call.
        self._gen = torch.Generator().manual_seed(_NOISE_SEED)
        self.frames_dispatched = 0  # decoded frames of all dispatched segments

        # ---- the controller's state (rank 0), on the host
        self._ops: list = []  # the plan of the tick being planned
        self._written = 0  # host mirror of the batch-common write index
        self._pos = [0] * slots  # host mirror of the active slots' stream positions
        self._epoch_counter = 0
        self._retired_epochs: set[int] = set()
        self._submitted: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()  # voice key -> voice
        self._named: dict[str, _NamedVoice] = {}  # predefined voices by name (voice_state)
        self._voice_requests: collections.deque = collections.deque()  # names to make at the next tick
        self._slots = [_Slot() for _ in range(slots)]
        self._parked: list[_Parked] = []
        self._parked_by_epoch: dict[int, _Parked] = {}
        self._free_lanes = list(range(self.max_parked)) if self.preempt else []
        # Observability.
        self.preemptions = 0  # parks, swaps included
        self.resumes = 0  # resumes, swaps included
        self.swaps = 0
        self.compactions = 0
        self.growths = 0
        # Seconds per pipelined tick while any stream is active (run()).
        self.tick_walls: list = []
        self._pending: "queue.Queue[tuple]" = queue.Queue()
        self._next_id = 0
        self._lock = threading.Lock()
        self._voice_lock = threading.Lock()
        self._stop = threading.Event()
        self._running = False
        self._just_admitted = False
        self._ticks_since_short = 1 << 30  # the first admission is always short
        self._deferred: list = []  # oversized items awaiting capacity growth

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
        not-yet-admitted backlog is full. On a mesh only rank 0 submits, a
        voice state the model made (its key names it on every rank)."""
        if not self._leader:
            raise RuntimeError(f"submit() on rank {self.mesh.rank}: on a mesh only rank 0 submits requests")
        self._voice_key(voice_state)
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

    def _voice_key(self, voice: ModelState):
        """The key that names `voice` in a plan: on a mesh the model's key
        (the same on every rank), on one card its identity (any voice state
        goes)."""
        key = id(voice)
        if self.mesh is not None:
            if voice.key is None or self.model._voices.get(voice.key) is not voice:
                raise ValueError("on a mesh the engine takes the voice states its model made (get_state_for_audio_"
                                 "prompt or voice_state): a plan names a voice by a key every rank resolves")
            key = voice.key
        self._submitted[key] = voice
        return key

    def voice_state(self, name: str) -> ModelState:
        """The state of the predefined voice `name` (made once, then cached).
        On one card it is made in the calling thread; on a mesh rank 0 asks
        for it and every rank makes it at the next tick boundary, as a plan
        item (its prefill is a collective), so the call waits for that tick
        of the running engine."""
        if self.mesh is None:
            with self._voice_lock:
                named = self._named.setdefault(name, _NamedVoice())
                if named.state is None:
                    named.state = self.model.get_state_for_audio_prompt(name)
                return named.state
        if not self._leader:
            raise RuntimeError(f"voice_state() on rank {self.mesh.rank}: on a mesh rank 0 asks for voices")
        with self._voice_lock:
            named = self._named.get(name)
            if named is None:
                named = self._named[name] = _NamedVoice()
                self._voice_requests.append(name)
        named.ready.wait()
        if named.error is not None:
            raise RuntimeError(f"voice {name!r} could not be made") from named.error
        return named.state

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
        """Plan the copy of the voice rows of a group of admissions into
        their slots: one scatter per state leaf for all slots of one voice.

        items: [(b, handle, voice_state, fae, max_gen, tokens)]. Returns
        [(b, tokens)] for the batched prefill."""
        admitted = []
        by_voice: dict = {}
        for it in items:
            by_voice.setdefault(self._voice_key(it[2]), []).append(it)
        for key, group in by_voice.items():
            voice_state = group[0][2]
            # The batch write index must clear the voice's own rows, or the
            # next prefill would overwrite them.
            self._written = max(self._written, voice_state.written)
            self._ops.append(("admit", key, [it[0] for it in group], [it[3] for it in group],
                              [it[4] for it in group], voice_state.pos[0], self._written))
            now = time.monotonic()
            for b, handle, voice, fae, max_gen, tokens in group:
                if handle.admit_time is None:
                    handle.admit_time = now
                self._pos[b] = voice.pos[0]
                slot = self._slots[b]
                slot.active, slot.handle, slot.frames_left = True, handle, max_gen
                self._epoch_counter += 1
                slot.epoch = self._epoch_counter
                logger.info("engine: admitted request %d into slot %d", handle.request_id, b)
                admitted.append((b, tokens))
        return admitted

    def _prefill_admitted(self, admitted: list[tuple[int, list[int]]]) -> None:
        """Plan one batched prefill for all newly admitted slots (others at
        length 0, which write only invalid rows), at the smallest bucketed
        width that holds the longest text."""
        longest = max((len(toks) for _, toks in admitted), default=0)
        width = next(w for w in self.prefill_buckets if w >= min(longest, self.text_pad))
        rows = []
        for b, toks in admitted:
            toks = list(toks[:width])
            rows.append((b, toks))
            self._pos[b] += len(toks)
        self._ops.append(("prefill", width, rows))
        self._written += width

    # ------------------------------------------------------------ preemption

    def _execute_parks(self, plan: list[tuple[int, float]]) -> None:
        """Park the planned victim slots into free lanes, all at once: their
        FlowLM rows compacted to the row front (resuming is then the
        admission contract, widx >= valid), Mimi state and carry as they are.
        plan: [(slot, lead)]; the caller guarantees a free lane each."""
        lanes = [self._free_lanes.pop() for _ in plan]
        self._ops.append(("park", [b for b, _ in plan], lanes))
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
        slot = self._slots[b]
        slot.active, slot.handle, slot.frames_left = True, parked.handle, parked.frames_left
        self._epoch_counter += 1
        slot.epoch = self._epoch_counter
        self.resumes += 1

    def _execute_resumes(self, plan: list[tuple[_Parked, int]]) -> bool:
        """Plan the copy of the parked lanes back into their slots, all at
        once: the mirror of admission, with the streams' own Mimi state and
        mid-flight carry."""
        live = self._live(plan)
        if not live:
            return False
        widx_new = max(p.valid for p, _ in live)
        self._written = max(self._written, widx_new)
        self._ops.append(("resume", [p.lane for p, _ in live], [b for _, b in live], [p.pos for p, _ in live],
                          widx_new))
        for parked, b in live:
            self._drop_parked(parked)
            self._restore(parked, b)
            logger.info("engine: resumed request %d into slot %d", parked.handle.request_id, b)
        return True

    def _execute_swaps(self, plan: list[tuple[_Parked, int, float]]) -> bool:
        """Plan the exchange of the victim slots' state with parked lanes'
        state: a park and a resume fused, so no free lane is needed. plan:
        [(parked, slot, victim_lead)]."""
        live = self._live(plan)
        if not live:
            return False
        widx_new = max(p.valid for p, _, _ in live)
        self._written = max(self._written, widx_new)
        self._ops.append(("swap", [p.lane for p, _, _ in live], [b for _, b, _ in live],
                          [p.pos for p, _, _ in live], widx_new))
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
        """Plan the expansion of the KV cache (and of the parking store,
        whose rows sit compacted at the row front) to the pending target
        capacity, at a tick boundary, then reclaim dead rows if that lowers
        the write index."""
        with self._lock:
            target = self._target_capacity
        if target <= self.capacity:
            return
        logger.info("engine: growing KV capacity %d -> %d", self.capacity, target)
        self._ops.append(("grow", target))
        self.capacity = target
        self.growths += 1
        max_valid = _ceil8(max(self._pos) + 1)
        if max_valid < self._written:
            self._compact(max_valid)

    def _compact(self, new_written: int) -> None:
        self._ops.append(("compact", new_written))
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
        """Plan the admission of queued requests; returns True if slot
        contents changed.

        Slot assignment within a tick: (1) urgent parked streams (lead below
        resume_urgent_lead_s) take free slots first, or swap with a running
        stream holding swap_margin_s more lead; (2) pending requests take the
        remaining free slots, and past those preempt the running streams
        with the most lead; (3) other parked streams fill what is left. The
        tick plans every move first, then one group park, one group swap, one
        group admission (+ one prefill) and one group resume.

        With block_seconds > 0 the first fetch blocks briefly (the idle run
        loop's wait)."""
        while self._voice_requests:
            self._ops.append(("voice", self._voice_requests.popleft()))
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

    def _dispatch_segment(self):
        """Plan one decode segment of every slot; returns what _deliver
        needs. The segment reads nothing back from the device, so a caller
        may dispatch the next segment before delivering this one (run())."""
        self._maybe_compact()
        if self._just_admitted:
            frames = self.first_segment_frames
            self._just_admitted = False
            self._ticks_since_short = 0
        else:
            frames = self.segment_frames
            self._ticks_since_short += 1
        # Slot ownership at dispatch time: delivery touches only the (slot,
        # handle, epoch) triples that decoded in THIS segment.
        rows = [(b, s.handle, s.epoch) for b, s in enumerate(self._slots) if s.active]
        for b, _, _ in rows:
            self._pos[b] += frames
            self._slots[b].frames_left -= frames
        self._written += frames
        # At partial occupancy on one card only the active rows' audio leaves
        # the device; a mesh fetches every row (as the JAX engine does).
        fetch_rows = rows if self.mesh is None and len(rows) < self.num_slots else None
        self._ops.append(("segment", frames, None if fetch_rows is None else [b for b, _, _ in rows]))
        return rows, fetch_rows

    def _deliver(self, dispatched) -> int:
        """Wait for a dispatched segment's outputs, push frames, retire slots.
        A cancelled stream's `max_gen = 0` write goes into the next plan."""
        rows, fetch_rows = dispatched
        audio_np, emit_np, counters = self._fetch()
        with trace.span("engine.deliver"):
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
                        self._ops.append(("cancel", [b]))  # the still-running decode emits nothing
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

    def _flush(self, deliveries: int = 0, end: bool = False) -> None:
        """Run the planned tick: on a mesh broadcast it to every rank, with
        the number of deliveries that follow it and whether it ends the
        followers' loop, then apply it here."""
        ops, self._ops = self._ops, []
        if self.mesh is not None:
            broadcast_from_rank0(self.mesh, (ops, deliveries, end))
        self._apply(ops)

    def _follow(self) -> None:
        """A follower's loop: apply rank 0's plans and take part in their
        deliveries until a plan ends it."""
        while True:
            ops, deliveries, end = broadcast_from_rank0(self.mesh)
            self._apply(ops)
            for _ in range(deliveries):
                self._fetch()
            if end:
                return

    @torch.no_grad()
    def step(self) -> int:
        """Admit, decode one segment, deliver its frames (synchronous tick).
        On a mesh rank 0 steps; every other rank's step() follows rank 0's
        plans until its run() or stop() ends them (and returns 0)."""
        if not self._leader:
            self._follow()
            return 0
        with trace.span("engine.tick"):
            with trace.span("engine.admit"):
                self._admit_pending()
            dispatched = self._dispatch_segment() if any(s.active for s in self._slots) else None
            self._flush(deliveries=int(dispatched is not None))
            if dispatched is None:
                return 0
            return self._deliver(dispatched)

    @torch.no_grad()
    def run(self, stop_when_idle: bool = True, max_ticks: Optional[int] = None) -> None:
        """Pump the engine until all submitted work is done (or forever, or
        until stop(), or for max_ticks decode ticks).

        Pipelined: segment k+1 is queued before segment k's outputs are read,
        so the device decodes while the host delivers frames. Retirement lags
        one segment; admission rewrites a slot's rows, so that is safe. On a
        mesh every rank calls run(): rank 0's ends every rank's."""
        if not self._leader:
            self._follow()
            return
        with self._lock:
            self._running = True
        try:
            self._run(stop_when_idle, max_ticks)
        except BaseException as exc:
            for named in self._named.values():  # wake voice_state() waiters
                if not named.ready.is_set():
                    named.error = exc
                    named.ready.set()
            raise
        finally:
            with self._lock:
                self._running = False

    def _run(self, stop_when_idle: bool, max_ticks: Optional[int]) -> None:
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
            # A tick with work is the interval tick_walls times; an idle
            # iteration (waiting for a request) is no tick.
            with (trace.OFF if fully_idle else trace.span("engine.tick")) as tick:
                with trace.span("engine.admit"):
                    self._admit_pending(block_seconds=0.05 if fully_idle else 0.0)
                short_tick = self._just_admitted  # consumed by _dispatch_segment
                any_active = any(s.active for s in self._slots)
                dispatched = self._dispatch_segment() if any_active else None
                deliveries = [] if in_flight is None else [in_flight]
                if dispatched is not None and short_tick:
                    # The tick after an admission carries the new streams' first
                    # frames: deliver it now rather than one tick later.
                    deliveries.append(dispatched)
                    dispatched = None
                if tick is not trace.OFF:
                    tick.set(slots=sum(s.active for s in self._slots),
                             frames=self._ops[-1][1] if any_active else 0,  # the segment: the plan's last item
                             admitted=sum(len(op[2]) for op in self._ops if op[0] == "admit"),
                             delivered=len(deliveries))
                self._flush(len(deliveries))
                for d in deliveries:
                    self._deliver(d)
            in_flight = dispatched
            ticks += any_active
            if max_ticks is not None and ticks >= max_ticks:
                break
            if (not any_active and in_flight is None and self._pending.empty() and not self._deferred
                    and not self._parked and not self._voice_requests):
                idle_ticks += 1
                if stop_when_idle and idle_ticks > 1:
                    break
            else:
                idle_ticks = 0
        self._flush(int(in_flight is not None), end=self.mesh is not None)
        if in_flight is not None:
            self._deliver(in_flight)
        self._stop.clear()

    def stop(self) -> None:
        """Make the running (or the next) run() return at its next tick, with
        nothing in flight (ends serve_forever_in_thread's loop). On a mesh,
        rank 0's stop() with no run() under way ends the followers' loop at
        once (after a step()-driven session); on other ranks it does
        nothing."""
        if not self._leader:
            return
        with self._lock:
            if self.mesh is not None and not self._running:
                self._flush(end=True)
                return
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

    # ------------------------------------------------------------ the executor
    #
    # Each plan item is (op, args...) with slots, lanes and write indices in
    # the whole engine's numbering; every rank applies it to the slots it
    # holds. The write index is batch-common and moves on every rank.

    def _apply(self, ops: list) -> None:
        with trace.span("engine.apply"):
            for op, *args in ops:
                with trace.span(_OP_SPANS[op]):
                    getattr(self, f"_op_{op}")(*args)

    def _held(self, slots: list[int]) -> tuple[list[int], list[int]]:
        """(positions in `slots`, local rows) of the slots this rank holds."""
        pick = [i for i, b in enumerate(slots) if self._lo <= b < self._hi]
        return pick, [slots[i] - self._lo for i in pick]

    def _voice(self, key) -> ModelState:
        voice = self._submitted.get(key) if self._leader else None
        return voice if voice is not None else self.model._voice_by_key(key)

    def _expanded_voice(self, key) -> dict:
        """Voice tree padded to the engine capacity (cached; the entry holds
        the ModelState, so an id() key cannot be recycled).
        Admission copies rows out of it and never writes it."""
        voice = self._voice(key)
        hit = self._voice_cache.get(key)
        if hit is None or hit[0] is not voice:
            tree = self.model.flow_lm.expand_state(voice.tree, self.model.flow_lm.state_capacity(self.flow_state))
            if len(self._voice_cache) >= 16:
                self._voice_cache.pop(next(iter(self._voice_cache)))
            hit = (voice, tree)
            self._voice_cache[key] = hit
        return hit[1]

    def _warm_mimi(self) -> dict:
        """One-row Mimi state after the zero-latent warmup (deterministic and
        voice-independent: computed once, copied into every admitted slot;
        on a mesh a tp-collective decode that every rank runs at its first
        admission)."""
        if self._warm_mimi_row is None:
            self._warm_mimi_row = self.model._warm_mimi_state(1, self.segment_frames, self.warmup_frames)
        return self._warm_mimi_row

    def _slot_rows(self, slots: list[int]) -> list:
        """Copies of rows `slots` of the FlowLM state (compacted to the row
        front), the Mimi state and the carry, on every rank: on a dp-sharded
        engine each rank takes the rows it holds (its first row in place of
        another rank's) and one all_gather over dp hands every rank the
        holder's rows."""
        idx = self._index([b - self._lo if self._lo <= b < self._hi else 0 for b in slots])
        rows = [self.model.flow_lm.compact_state(_take(self.flow_state, idx), 0), _take(self.mimi_state, idx),
                _take(self.carry, idx)]
        if self._sharded:
            per_rank = self._hi - self._lo
            _share_rows(self.mesh, rows, [b // per_rank for b in slots])
        return rows

    def _enter(self, local: list[int], positions: list[int], rows: list) -> None:
        """Write `rows` (FlowLM, Mimi and carry trees, one row per entry of
        `local`) into this rank's rows `local`, with their stream positions."""
        if not local:
            return
        dst = self._index(local)
        _put(self.flow_state["transformer"], rows[0]["transformer"], dst)
        _put(self.mimi_state, rows[1], dst)
        _put(self.carry, rows[2], dst)
        for row, pos in zip(local, positions):
            self.flow_state["pos"][row] = pos

    def _stored_rows(self, lanes: list[int]) -> list:
        idx = self._index(lanes)
        return [_take(self._store_flow, idx), _take(self._store_mimi, idx), _take(self._store_carry, idx)]

    def _raise_widx(self, widx: int) -> None:
        tstate = self.flow_state["transformer"]
        tstate["widx"] = max(tstate["widx"], widx)

    def _op_voice(self, name: str) -> None:
        state = self.model.get_state_for_audio_prompt(name)  # a collective prefill on a mesh
        if self._leader:
            named = self._named[name]
            named.state = state
            named.ready.set()
        else:
            self._named[name] = _NamedVoice(state)  # held, so rank 0's key resolves here

    def _op_grow(self, capacity: int) -> None:
        fl = self.model.flow_lm
        self.model.step_graphs.forget(self.flow_state["transformer"])  # bound to the buffers growth replaces
        self.flow_state = fl.expand_state(self.flow_state, capacity)
        if self.preempt:
            self._store_flow = fl.expand_state(self._store_flow, capacity)
        self._voice_cache.clear()  # cached voices are padded to the old size

    def _op_compact(self, new_written: int) -> None:
        # In place: the decode step captured on these buffers replays on.
        self.flow_state = self.model.flow_lm.compact_state(self.flow_state, new_written)

    def _op_park(self, slots: list[int], lanes: list[int]) -> None:
        dst = self._index(lanes)
        for store, rows in zip((self._store_flow, self._store_mimi, self._store_carry), self._slot_rows(slots)):
            _put(store, rows, dst)

    def _op_swap(self, lanes: list[int], slots: list[int], positions: list[int], widx: int) -> None:
        # Both sides are read (copied) before either is written.
        pick, local = self._held(slots)
        entering = self._stored_rows([lanes[i] for i in pick])
        self._op_park(slots, lanes)
        self._raise_widx(widx)
        self._enter(local, [positions[i] for i in pick], entering)

    def _op_resume(self, lanes: list[int], slots: list[int], positions: list[int], widx: int) -> None:
        # Resumed rows hold entries in [0, valid): the write index clears them.
        pick, local = self._held(slots)
        self._raise_widx(widx)
        self._enter(local, [positions[i] for i in pick], self._stored_rows([lanes[i] for i in pick]))

    def _op_admit(self, key, slots: list[int], faes: list[int], max_gens: list[int], pos0: int, written: int) -> None:
        warm = self._warm_mimi()
        self._raise_widx(written)
        pick, local = self._held(slots)
        if not local:
            return
        idx = self._index(local)
        _put(self.flow_state["transformer"], self._expanded_voice(key)["transformer"], idx)
        for row in local:
            self.flow_state["pos"][row] = pos0
        _put(self.mimi_state, warm, idx)
        carry = self.carry
        carry["latent"].index_fill_(0, idx, 0.0)
        carry["is_bos"].index_fill_(0, idx, True)
        carry["eos_step"].index_fill_(0, idx, _EOS_NEVER)
        carry["step"].index_fill_(0, idx, 0)
        counts = host_to_device(torch.tensor([[faes[i] for i in pick], [max_gens[i] for i in pick]]), self.device)
        carry["frames_after_eos"].index_copy_(0, idx, counts[0].to(carry["frames_after_eos"].dtype))
        carry["max_gen"].index_copy_(0, idx, counts[1].to(carry["max_gen"].dtype))

    def _op_prefill(self, width: int, rows: list) -> None:
        B = self._hi - self._lo
        tokens = torch.zeros(B, width, dtype=torch.long)
        lengths = [0] * B
        for b, toks in rows:
            if self._lo <= b < self._hi:
                tokens[b - self._lo, : len(toks)] = torch.tensor(toks, dtype=torch.long)
                lengths[b - self._lo] = len(toks)
        fl, flow_params = self.model.flow_lm, self.model.params["flow_lm"]
        emb = fl.embed_text(flow_params, host_to_device(tokens, self.device))
        self.flow_state = fl.prefill(flow_params, self.flow_state, emb, lengths)

    def _op_cancel(self, slots: list[int]) -> None:
        _, local = self._held(slots)
        if local:
            self.carry["max_gen"].index_fill_(0, self._index(local), 0)

    def _op_segment(self, frames: int, fetch: Optional[list[int]]) -> None:
        model = self.model
        # The whole batch's noise on every rank (one generator stream), this
        # rank's rows of it.
        noise = sample_noise(self._gen, (frames, self.num_slots, model.flow_lm.ldim), model.temp, model.noise_clamp)
        noise = host_to_device(noise[:, self._lo : self._hi].contiguous(), self.device)
        self.flow_state, self.mimi_state, self.carry, audio, emit, _ = run_segment(
            model.flow_lm, model.mimi, model.params, self.flow_state, self.mimi_state, self.carry, noise,
            model.lsd_decode_steps, model.eos_threshold, emit_pcm16=self.emit_pcm16, step_graphs=model.step_graphs,
        )
        self.frames_dispatched += frames
        if fetch is not None:
            idx = self._index(fetch)
            audio, emit = audio.index_select(0, idx), emit.index_select(0, idx)
        # Snapshot of the carry fields delivery reads: frames_after_eos and
        # max_gen are written in place by later admissions and cancellations.
        c = self.carry
        counters = torch.stack([c["eos_step"], c["step"], c["frames_after_eos"].to(c["step"].dtype),
                                c["max_gen"].to(c["step"].dtype)])
        self._outputs.append(self._to_host([audio, emit, counters]))

    def _to_host(self, tensors: list[torch.Tensor]):
        """Queue device->host copies of `tensors` into pinned buffers and
        record an event that _fetch waits on: no host sync at dispatch.
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

    def _fetch(self) -> list:
        """The oldest undelivered segment's audio, emit flags and counters on
        the host; on a dp-sharded engine those of every slot, gathered over
        dp."""
        with trace.span("engine.fetch"):
            host, event = self._outputs.popleft()
            if event is not None:
                event.synchronize()
            arrays = [t.numpy() for t in host]
            if self._sharded:
                parts = all_gather_dp(self.mesh, arrays)
                arrays = [np.concatenate([p[i] for p in parts], axis=1 if i == 2 else 0) for i in range(3)]
            return arrays

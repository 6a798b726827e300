"""The batch decode step (B > 1) as the replay of a captured CUDA graph.

The plain step of B streams (FlowLMModel.backbone_step and flow_step: the
int8 linear kernel, the batch attention kernel, the flow head) is
several hundred kernels launched from Python, which takes the host longer
than the card takes to run them. StepGraphs captures that step once per key
and replays it: per frame the host copies the noise row into the graph's
input, uploads the stream positions and the write index from pinned memory
(queued, no host sync), replays, and copies the latent and the EOS flags out
into the segment's [S, B, ...] outputs. The kernels, their precisions and
their arguments are the eager step's, so a replay gives the eager step's
bits.

When (models/generate.step_graph_ok): B > 1, a state on a CUDA device, no
mesh (its collectives stay eager), and neither B=1 kernel would run (the
segment kernel, the per-frame kernel). Everything else decodes eagerly.

Key: B, the cache capacity C, the rows the attention reads (R), the KV and
latent dtypes, the flow steps, the EOS threshold, the params and the
storage of every cache leaf the graph was captured on. Callers keep those
buffers for their life (the engine compacts in place; the batch path
decodes in a state that the model keeps per (B, C, KV dtype)), so a key is
captured once. The first frame of a new key runs the step eagerly on a side
stream (it warms the kernels and the allocator, and is the frame's real
work), then the step is captured on the calling thread in thread-local
capture mode, so that other threads may use the card meanwhile; the later
frames replay. The graph's inputs and outputs are its own static buffers
outside any pool, so every graph shares one memory pool, which holds the
intermediates of the largest step (66 MiB for b6369a24 in int8 at B=64 with
int8 KV, on an H100 80GB). The first capture of a process also pays for the
first use of the batch attention and int8 linear kernels in its warm-up
frame, their nvcc builds included where build/kernels/ holds none yet.

A replay launches the graph through libcuda's cuGraphLaunch, bound with
ctypes.PyDLL so that the call keeps the GIL (CUDAGraph.replay lets it go).
On an H100 with torch 2.11+cu128, a replay on the engine's serving thread
while another thread stopped torch.profiler's CUDA trace deadlocked inside
the CUDA libraries: in 4 runs of one trace start and stop a second, each
hung within 8 cycles (with eager steps, none in 60). The profiler's stop
holds the GIL, so a launch that holds it too never overlaps it. The step
draws no random numbers (its noise is an input), so the generator prologue
of CUDAGraph.replay has nothing to do.

Kernel wrappers count no launch while a graph is captured; the capture
tallies them per wrapper (ops/_cuda.captured_launches) and each replay adds
that tally to the wrappers' counters: at b6369a24 in int8, 6
batch_decode_attention and 25 int8_linear launches a frame.
Counters: `captures`, `replays`, and `eager_steps` (batch steps on the card
decoded eagerly: warm-up frames, mesh steps); no benchmark metric reads
them. With the span recorder on (utils/trace.py), run_segment sets the
`segment.flow` span's attribute `replayed`: the frames that replayed a
captured step. There is no knob: on the CPU, at B=1 and on a mesh the step
runs eagerly.
"""

from __future__ import annotations

import collections
import ctypes
import threading

import torch

from pocket_tts_tpu_torch.ops import _cuda
from pocket_tts_tpu_torch.utils.transfer import host_to_device


_cu_graph_launch = None  # cuGraphLaunch, bound at the first replay


def _launch(graph: torch.cuda.CUDAGraph) -> None:
    """Launch `graph` on the current stream, holding the GIL throughout."""
    global _cu_graph_launch
    if _cu_graph_launch is None:
        fn = ctypes.PyDLL("libcuda.so.1").cuGraphLaunch
        fn.argtypes, fn.restype = (ctypes.c_void_p, ctypes.c_void_p), ctypes.c_int
        _cu_graph_launch = fn
    err = _cu_graph_launch(graph.raw_cuda_graph_exec(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"cuGraphLaunch failed: CUresult {err}")


class _Step:
    """One captured step: its static inputs (latent, BOS flags, noise, and
    the positions followed by the write index) and outputs (the next latent,
    written into `latent`, and the EOS flags); `launches`, {kernel wrapper:
    launches} of one replay."""

    __slots__ = ("graph", "latent", "bos", "noise", "index", "eos", "launches")

    def __init__(self, latent: torch.Tensor):
        B, ldim = latent.shape
        self.graph = None
        self.latent = torch.empty_like(latent)
        self.bos = torch.empty(B, dtype=torch.bool, device=latent.device)
        self.noise = torch.empty(B, ldim, dtype=torch.float32, device=latent.device)
        self.index = torch.empty(B + 1, dtype=torch.int32, device=latent.device)
        self.eos = torch.empty(B, dtype=torch.bool, device=latent.device)
        self.launches = {}


class StepGraphs:
    """Captured batch decode steps of one model, shared by its batch path
    and its engines."""

    MAX_GRAPHS = 64  # the oldest key is dropped past this many

    def __init__(self):
        self.captures = 0
        self.replays = 0
        self.eager_steps = 0
        self._steps: "collections.OrderedDict[tuple, _Step]" = collections.OrderedDict()
        self._pool = None
        self._side = None  # the warm-ups' stream: one, so their cached blocks are reused
        self._lock = threading.Lock()

    @staticmethod
    def _key(flow_params, tstate, latent, lsd_decode_steps, eos_threshold, read_limit) -> tuple:
        layers = tstate["layers"]
        k = layers[0]["k"]
        B, C = k.shape[:2]
        R = C if read_limit is None else max(8, min(int(read_limit), C))
        buffers = tuple(leaf.data_ptr() for layer in layers for leaf in layer.values())
        return (B, C, R, k.dtype, latent.dtype, int(lsd_decode_steps), float(eos_threshold), id(flow_params),
                buffers)

    def forget(self, tstate: dict) -> None:
        """Drop the steps captured on the cache buffers of `tstate` (a state
        about to be freed)."""
        buffers = tuple(leaf.data_ptr() for layer in tstate["layers"] for leaf in layer.values())
        with self._lock:
            for key in [key for key in self._steps if key[-1] == buffers]:
                del self._steps[key]

    def decode(self, flow_lm, flow_params, state: dict, latent: torch.Tensor, is_bos, noise_seq: torch.Tensor,
               lsd_decode_steps: int, eos_threshold: float, read_limit=None):
        """S frames of B streams -> (latents [S, B, ldim], EOS flags [S, B],
        frames replayed). The caches update in place and the host write
        index and positions advance, as S decode_step calls do."""
        S, B, ldim = noise_seq.shape
        tstate = state["transformer"]
        key = self._key(flow_params, tstate, latent, lsd_decode_steps, eos_threshold, read_limit)
        with self._lock:
            step = self._steps.get(key)
            if step is None:
                step = self._steps[key] = _Step(latent)
                while len(self._steps) > self.MAX_GRAPHS:
                    self._steps.popitem(last=False)

        def run():
            # A shallow copy: the caches are the state's, the write index the
            # device copy, and the host index stays for the loop to advance.
            h, eos_logits = flow_lm.backbone_step(flow_params, {**tstate, "widx": step.index[B:]}, step.latent,
                                                  step.bos, step.index[:B].view(B, 1), read_limit)
            step.latent.copy_(flow_lm.flow_step(flow_params, h, step.noise, lsd_decode_steps))
            step.eos.copy_(eos_logits > eos_threshold)
            step.bos.fill_(False)  # every later frame of the segment

        latents = torch.empty((S, B, ldim), dtype=latent.dtype, device=latent.device)
        eos = torch.empty((S, B), dtype=torch.bool, device=latent.device)
        step.latent.copy_(latent)
        if isinstance(is_bos, torch.Tensor):
            step.bos.copy_(is_bos)
        else:
            step.bos.fill_(bool(is_bos))
        replayed = 0
        for i in range(S):
            step.noise.copy_(noise_seq[i])
            step.index.copy_(host_to_device(torch.tensor(state["pos"] + [tstate["widx"]], dtype=torch.int32),
                                            step.index.device))
            if step.graph is None:
                self._capture(step, run)
            else:
                self._replay(step.graph)
                for wrapper, n in step.launches.items():
                    wrapper.launches += n
                self.replays += 1
                replayed += 1
            latents[i].copy_(step.latent)
            eos[i].copy_(step.eos)
            tstate["widx"] += 1
            state["pos"] = [p + 1 for p in state["pos"]]
        return latents, eos, replayed

    _replay = staticmethod(_launch)

    def _capture(self, step: _Step, run) -> None:
        """Run this frame's step eagerly on a side stream (the warm-up), then
        capture it on the calling thread; one capture at a time."""
        with self._lock:
            if self._side is None:
                self._side = torch.cuda.Stream()
            self._side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self._side):
                run()
            torch.cuda.current_stream().wait_stream(self._side)
            self.eager_steps += 1
            graph = torch.cuda.CUDAGraph()
            with _cuda.captured_launches() as launches, \
                    torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
                run()
            step.launches = launches
            if self._pool is None:
                self._pool = graph.pool()
        step.graph = graph
        self.captures += 1

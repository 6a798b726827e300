"""A run of each cell on the CPU at a tiny configuration, past the look for
a card: the traffic, the window, the metrics' readers, the trace (host
operators off the card) and the check against the reference. The same runs
with the timed path broken underneath must come out not correct."""

import copy
import json
import time

import pytest
import torch

import run
from common import HERE, load_json

TINY = load_json(HERE / "tests" / "tiny.json")
SMALL = {  # the cells' traffic cut to what a CPU run holds in a few seconds
    "engine64-poisson": {"slots": 4, "rate": 2.0, "warmup_seconds": 1.0, "capacity": 256},
    "stream-b1": {"warmup_requests": 2},
    "batch64-offline": {"batch": 8},
    "clone-stream": {"wavs": 2, "prompt_seconds": 2.0},
}


def rehearse(cell: str, trace: int = 0, seed: int = 3_000_000_019) -> dict:
    workload = load_json(HERE / "workloads" / f"{cell}.json")
    workload["params"].update(SMALL[cell])
    config = copy.deepcopy(TINY)
    stated = load_json(HERE / "configs" / f"{workload['config']}.json")
    config["serving"]["kv_int8"] = stated["serving"]["kv_int8"]
    config["numerics"], config["controls"] = stated["numerics"], stated["controls"]
    args = run.parse(["--workload", cell, "--seed", str(seed), "--seconds", "1.5", "--trace", str(trace)])
    return run.run(args, workload, config, torch.device("cpu"), torch, t_start=time.monotonic())


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_cell_rehearsal(cell):
    result = rehearse(cell)
    assert result["correct"], result["check"]
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "check"
    assert result["metrics"] == {}  # nothing from a CPU run under a device metric's name
    assert result["device"]["platform"] == "cpu"
    assert "setup_s" in result["rehearsal"] and "audio_s_per_s" in result["rehearsal"]
    assert result["attempted"] > 0 and result["failed"] == 0
    json.dumps(result)


def test_traced_rehearsal_reads_layers():
    result = rehearse("stream-b1", trace=1)
    assert result["correct"]
    assert "model.prefill_ms" in result["rehearsal"] and "device.idle_share" in result["rehearsal"]
    assert result["device"]["window_s"] > 0
    assert len(result["breakdown"]["device_ops"]) <= 10 and len(result["breakdown"]["idle_gaps"]) <= 10


def _alter_a_frame(monkeypatch):
    """A frame's audio altered where it is produced (its sign flipped)."""
    from pocket_tts_tpu_torch.models import generate

    decode = generate.decode_mimi_chunk

    def altered(*args, **kwargs):
        audio, state = decode(*args, **kwargs)
        audio = audio.clone()
        audio[:, -1] = -audio[:, -1]
        return audio, state

    monkeypatch.setattr(generate, "decode_mimi_chunk", altered)


def _state_unchanged(monkeypatch):
    """A decode segment that hands back the carry it was given: every
    segment starts again from the same latent."""
    from pocket_tts_tpu_torch.models import generate, tts_model
    from pocket_tts_tpu_torch.serving import engine

    segment = generate.run_segment

    def stuck(flow_lm, mimi, params, flow_state, mimi_state, carry, *args, **kwargs):
        latent = carry["latent"].clone()
        out = list(segment(flow_lm, mimi, params, flow_state, mimi_state, carry, *args, **kwargs))
        out[2] = {**out[2], "latent": latent}
        return tuple(out)

    monkeypatch.setattr(tts_model, "run_segment", stuck)
    monkeypatch.setattr(engine, "run_segment", stuck)


def _half_the_batch(monkeypatch):
    """A batch call that decodes the first half of its texts and leaves the
    rest out."""
    from pocket_tts_tpu_torch.models.tts_model import TTSModel

    batch = TTSModel.generate_audio_batch

    def half(self, states, texts, *args, **kwargs):
        return batch(self, states, list(texts)[: len(texts) // 2], *args, **kwargs)

    monkeypatch.setattr(TTSModel, "generate_audio_batch", half)


@pytest.mark.parametrize("cell,fault", [
    ("stream-b1", _alter_a_frame), ("stream-b1", _state_unchanged),
    ("batch64-offline", _alter_a_frame), ("batch64-offline", _half_the_batch),
    ("engine64-poisson", _alter_a_frame), ("engine64-poisson", _state_unchanged),
    ("clone-stream", _alter_a_frame),
])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    result = rehearse(cell)
    assert not result["correct"], result["check"]


@pytest.mark.parametrize("cell", ["stream-b1", "batch64-offline"])
def test_the_control_fails_the_cells_check(cell, tmp_path):
    """The control of the cell's configuration (its first `controls` entry:
    the reference one precision step below what it states) in the
    program's place is judged not correct by run.check at a size a CPU test
    holds (tests/small.json: the FlowLM at full width, 2 layers; a narrow
    Mimi), on three seeds, two requests each; the chip's readings at the
    cells' size come from calibrate.py."""
    import calibrate

    workload = load_json(HERE / "workloads" / f"{cell}.json")
    workload["params"]["max_words"], workload["check_requests"] = 20, 2
    stated = load_json(HERE / "configs" / f"{workload['config']}.json")
    small = load_json(HERE / "tests" / "small.json")
    small["serving"]["kv_int8"] = stated["serving"]["kv_int8"]
    small["numerics"], small["controls"] = stated["numerics"], stated["controls"]
    for seed in (11, 22, 33):
        ok, numbers = calibrate.control_check(workload, small, seed, small["controls"][0], torch.device("cpu"), tmp_path)
        assert not ok, numbers
        assert numbers["audio_gap"]["value"] > numbers["audio_gap"]["limit"], numbers

"""The system under test: the port's TTSModel, built from a configuration
file with weights the benchmark makes from the seed on the device."""

from __future__ import annotations

import time

from common import Context, reference_module


def build_model(ctx: Context):
    """TTSModel.from_params of the configuration's model with the
    reference's seeded weights (made on the device, handed over in float32,
    cast and quantised by the program as the configuration states)."""
    from pocket_tts_tpu_torch.config.schema import Config
    from pocket_tts_tpu_torch.models.tts_model import TTSModel

    ref = reference_module(ctx.config)
    cfg, serving = ctx.config["model"], ctx.config["serving"]
    t0 = time.monotonic()
    params = ref.make_params(cfg, ctx.seed, ctx.device)
    model = TTSModel.from_params(
        Config(**cfg), params, ref.HashTokenizer(cfg["flow_lm"]["lookup_table"]["n_bins"]),
        serving["param_dtype"], device=ctx.device, temp=serving["temperature"],
        lsd_decode_steps=serving["lsd_decode_steps"], eos_threshold=serving["eos_threshold"],
        kv_int8=serving["kv_int8"], seed=ctx.seed % 2**63,
    )
    del params
    # No voice asset is reachable: the predefined voices are the program's
    # seeded stand-ins, as a model with random weights gives them.
    model.random_init = True
    ctx.setup_split["model"] = time.monotonic() - t0
    return model

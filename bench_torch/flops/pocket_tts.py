"""Model FLOPs of one decoded frame of pocket-tts, from the configuration's
shapes (2 per multiply-add), whatever implements it: the FlowLM step (input
projection, per layer the QKV, attention over the frame's valid rows, the
output projection and the feed-forward, then the EOS head), the flow head
for each LSD step (both timestep embedders, the conditioning, the AdaLN
blocks and the final layer) and the Mimi decoder's share of the frame (the
quantiser projection, the depthwise upsampler, the windowed transformer at
the 200 Hz rate and the SEANet decoder)."""

import math


def flowlm_flops(model: dict, valid_rows: int, lsd_steps: int = 1) -> float:
    t, fl = model["flow_lm"]["transformer"], model["flow_lm"]["flow"]
    E, L, F = t["d_model"], t["num_layers"], t["d_model"] * t["hidden_scale"]
    mc, depth = fl["dim"], fl["depth"]
    ld = model["mimi"]["quantizer"]["dimension"]
    step = 2 * E * ld + L * (2 * 4 * E * E + 2 * 2 * E * valid_rows + 2 * 2 * E * F) + 2 * E
    head = 2 * (mc * E + mc * ld + 2 * (mc * 256 + mc * mc) + depth * (3 * mc * mc + 2 * mc * mc) + 2 * mc * mc
                + ld * mc)
    return step + lsd_steps * head


def mimi_flops(model: dict, frame_index: int) -> float:
    """The Mimi decoder's FLOPs for frame `frame_index` of a request (the
    warm-up frame comes before frame 0)."""
    mi = model["mimi"]
    s, tr = mi["seanet"], mi["transformer"]
    stride = int(mi["sample_rate"] / math.prod(s["ratios"]) / mi["frame_rate"])
    d, ld = s["dimension"], mi["quantizer"]["dimension"]
    total = 2 * ld * mi["quantizer"]["output_dimension"] + 2 * d * 2 * stride
    dm = tr["d_model"]
    for i in range(stride):
        rows = min(tr["context"], stride * (frame_index + 1) + i + 1)
        total += tr["num_layers"] * (2 * 4 * dm * dm + 2 * 2 * dm * rows + 2 * 2 * dm * tr["dim_feedforward"])
    steps, mult, nf = stride, 2 ** len(s["ratios"]), s["n_filters"]
    total += steps * 2 * d * mult * nf * s["kernel_size"]
    for r in s["ratios"]:
        cin, cout = mult * nf, mult * nf // 2
        total += steps * 2 * cin * cout * 2 * r
        steps *= r
        h = cout // s["compress"]
        total += s["n_residual_layers"] * steps * (2 * cout * h * s["residual_kernel_size"] + 2 * h * cout)
        mult //= 2
    return total + steps * 2 * nf * s["channels"] * s["last_kernel_size"]


def frame_flops(model: dict, valid_rows: int, frame_index: int, lsd_steps: int = 1) -> float:
    return flowlm_flops(model, valid_rows, lsd_steps) + mimi_flops(model, frame_index)

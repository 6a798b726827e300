// Hopper port of the JAX package's fused_backbone_step
// (pocket_tts_tpu/ops/fused_backbone.py:fused_backbone_step, Pallas kernel
// `_kernel`): one B=1 FlowLM decode frame — BOS/latent select, the int8
// input projection, 6 pre-LN layers with int8 weight-only matmuls, RoPE,
// attention over the slot-major cache with in-place (k, v) appends at widx,
// then out_norm, the EOS logit and the slot_pos append.
//
// Bound on the H100: the 75.5 MB of int8 weights each frame reads once
// (about 23 us at 3.35 TB/s); see decode_common.cuh for how the GEMVs stream
// them. This first form launches one kernel per GEMV/attention/head step
// (32 launches per frame at 6 layers) from one host call.

#include "decode_common.cuh"

extern "C" int ptt_fused_backbone_step(const PttBackbone* a, const float* latent, int is_bos, int qpos,
                                       int widx, float* h_out, float* eos_out, void* stream) {
  return (int)ptt::backbone_frame(*a, latent, is_bos, qpos, widx, h_out, eos_out, (cudaStream_t)stream);
}

// Hopper port of the JAX package's fused_segment_decode
// (pocket_tts_tpu/ops/fused_segment.py:fused_segment_decode, Pallas kernel
// `_seg_kernel`): S autoregressive FlowLM frames, each the backbone frame of
// fused_backbone.cu followed by the flow-matching head — one Euler step
// (s=0, t=1) of SimpleMLPAdaLN on bf16 weights with float32 accumulation —
// whose latent (noise + velocity) feeds the next frame. Later frames read
// the (k, v) rows earlier frames appended.
//
// Bound on the H100: per frame, the 75.5 MB int8 backbone stream plus about
// 20 MB of bf16 flow weights (the 10240 x 512 AdaLN stack dominates). The
// flow GEMVs reuse the backbone's warp-per-row streaming with fused SiLU,
// AdaLN-modulate, gate-residual and Euler-update epilogues; the timestep
// embedding of the one Euler step is precomputed at pack time. The host loop
// over frames runs here in C: one host call per segment.

#include "decode_common.cuh"

namespace ptt {

static cudaError_t flow_frame(const PttFlow& f, int ldim, int E, const float* h, const float* noise,
                              float* latent_out, cudaStream_t st) {
  const int MC = f.MC, NA = (3 * f.depth + 2) * MC;
  {  // y = cond(h) + tcomb
    Pro p{}; p.mode = PRO_CAST; p.x = h;
    Epi e{}; e.mode = EPI_STORE; e.out = f.y; e.bias = f.bc; e.bias2 = f.tcomb;
    PTT_TRY(gemv<bf16>(f.wc, MC, E, p, e, st));
  }
  {  // fx = input_proj(noise)
    Pro p{}; p.mode = PRO_CAST; p.x = noise;
    Epi e{}; e.mode = EPI_STORE; e.out = f.fx; e.bias = f.b_in;
    PTT_TRY(gemv<bf16>(f.win, MC, ldim, p, e, st));
  }
  {  // every block's (shift, scale, gate) and the final (shift, scale) from silu(y)
    Pro p{}; p.mode = PRO_SILU; p.x = f.y;
    Epi e{}; e.mode = EPI_STORE; e.out = f.ada; e.bias = f.ba;
    PTT_TRY(gemv<bf16>(f.wa, NA, MC, p, e, st));
  }
  for (int i = 0; i < f.depth; ++i) {
    const float* ada = f.ada + (size_t)i * 3 * MC;
    {
      Pro p{}; p.mode = PRO_ADALN; p.x = f.fx; p.w = f.lnw + (size_t)i * MC; p.b = f.lnb + (size_t)i * MC;
      p.eps = 1e-6f; p.shift = ada; p.scale = ada + MC;
      Epi e{}; e.mode = EPI_SILU; e.out = f.u; e.bias = f.b0 + (size_t)i * MC;
      PTT_TRY(gemv<bf16>(f.w0 + (size_t)i * MC * MC, MC, MC, p, e, st));
    }
    {
      Pro p{}; p.mode = PRO_CAST; p.x = f.u;
      Epi e{}; e.mode = EPI_ADD; e.out = f.fx; e.bias = f.b2 + (size_t)i * MC; e.gate = ada + 2 * MC;
      PTT_TRY(gemv<bf16>(f.w2 + (size_t)i * MC * MC, MC, MC, p, e, st));
    }
  }
  {  // affine-free final LN, modulate, output projection, Euler update from x0 = noise
    const float* ada = f.ada + (size_t)f.depth * 3 * MC;
    Pro p{}; p.mode = PRO_ADALN; p.x = f.fx; p.eps = 1e-6f; p.shift = ada; p.scale = ada + MC;
    Epi e{}; e.mode = EPI_FINAL; e.out = latent_out; e.bias = f.bf; e.base = noise;
    PTT_TRY(gemv<bf16>(f.wf, ldim, MC, p, e, st));
  }
  return cudaSuccess;
}

}  // namespace ptt

extern "C" int ptt_fused_segment_decode(const PttBackbone* a, const PttFlow* f, const float* latent, int is_bos,
                                        const float* noise, int S, int qpos0, int widx0, float* latents_out,
                                        float* eos_out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int ldim = a->ldim;
  for (int s = 0; s < S; ++s) {
    const float* in_x = s == 0 ? latent : latents_out + (size_t)(s - 1) * ldim;
    const int widx = widx0 + s < a->C - 1 ? widx0 + s : a->C - 1;
    cudaError_t e = ptt::backbone_frame(*a, in_x, s == 0 ? is_bos : 0, qpos0 + s, widx, a->h, eos_out + s, st);
    if (e != cudaSuccess) return (int)e;
    e = ptt::flow_frame(*f, ldim, a->E, a->h, noise + (size_t)s * ldim, latents_out + (size_t)s * ldim, st);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

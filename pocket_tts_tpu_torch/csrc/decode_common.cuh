// Shared definitions of the two B=1 FlowLM decode kernels
// (fused_backbone.cu, fused_segment.cu): the argument blocks the host fills
// (mirrored by ctypes in ops/_cuda.py), warp reductions, the 16-byte dot
// products of a weight slice with a bf16 activation, and the roundings and
// activations of the JAX int8 path. Built with nvcc for sm_90a into
// plain-C shared libraries (see pocket_tts_tpu_torch/ops/_cuda.py).
//
// What bounds a frame on the H100: at B=1 every weight is read once per frame
// and used for one multiply-add, so the frame is a stream of weight bytes —
// 75.5 MB of int8 backbone weights (6 layers x 12 E*E chunks) plus, in the
// segment kernel, about 20 MB of bf16 flow-head weights. Both kernels are one
// persistent cooperative launch per call (persistent_decode.cuh,
// persistent_frame.cuh).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define PTT_MAX_LAYERS 16

typedef __nv_bfloat16 bf16;

// Host-side argument blocks (mirrored by ctypes.Structure in ops/_cuda.py).
struct PttBackbone {
  const int8_t* wqkv; const float* sqkv;  // [L, 3E, E], [L, 3E]
  const int8_t* wo; const float* so;      // [L, E, E], [L, E]
  const int8_t* w1; const float* s1;      // [L, FF, E], [L, FF]
  const int8_t* w2; const float* s2;      // [L, E, FF], [L, E]
  const float* ln;                        // [L, 4, E]: ln1 w, ln1 b, ln2 w, ln2 b
  const int8_t* win; const float* s_in;   // input_linear [E, ldim], [E]
  const float* bos;                       // [ldim]
  const float* out_norm;                  // [2, E]: w, b
  const float* eos_w; const float* eos_b; // [E], [1]
  bf16* k[PTT_MAX_LAYERS];                // per layer [C, H, d] slot-major
  bf16* v[PTT_MAX_LAYERS];
  int* slot_pos;                          // [C]
  float* x; float* qkv;                   // scratch [E], [3E]
  bf16* hidden;                           // scratch [FF]
  int L, E, H, FF, ldim, C;
  float rope_coef;                        // -log(max_period) * 2 / d (float32)
};

struct PttFlow {
  const bf16* wc; const float* bc; const float* tcomb;  // cond [MC, E], [MC], [MC]
  const bf16* win; const float* b_in;                    // input [MC, ldim], [MC]
  const bf16* wa; const float* ba;                       // AdaLN stack [NA, MC], [NA]
  const bf16* w0; const float* b0;                       // [depth, MC, MC], [depth, MC]
  const bf16* w2; const float* b2;                       // [depth, MC, MC], [depth, MC]
  const float* lnw; const float* lnb;                    // [depth, MC]
  const bf16* wf; const float* bf;                       // [ldim, MC], [ldim]
  float* y; float* ada; float* fx; float* u;             // scratch [MC], [NA], [MC], [MC]
  int MC, depth;
};

namespace ptt {

constexpr int kHeadDim = 64;  // attention layout: 8 lanes x 8 dims (16 bytes) per row

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float bf16_round(float v) { return __bfloat162float(__float2bfloat16(v)); }
__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }
__device__ __forceinline__ float gelu_erf(float v) { return 0.5f * v * (1.f + erff(v * 0.7071067811865476f)); }

// Products of two bf16-exact values are exact in float32; sums accumulate
// in float32. 16 weights per 16-byte load for int8, 8 for bf16.
__device__ __forceinline__ float dot16(const int8_t* w, const bf16* x) {
  const int4 wv = *reinterpret_cast<const int4*>(w);
  const int8_t* wb = reinterpret_cast<const int8_t*>(&wv);
  const uint4 x0 = *reinterpret_cast<const uint4*>(x);
  const uint4 x1 = *reinterpret_cast<const uint4*>(x + 8);
  const bf16* xa = reinterpret_cast<const bf16*>(&x0);
  const bf16* xc = reinterpret_cast<const bf16*>(&x1);
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) acc = fmaf((float)wb[j], __bfloat162float(xa[j]), acc);
#pragma unroll
  for (int j = 0; j < 8; ++j) acc = fmaf((float)wb[8 + j], __bfloat162float(xc[j]), acc);
  return acc;
}

__device__ __forceinline__ float dot16(const bf16* w, const bf16* x) {
  const uint4 wv = *reinterpret_cast<const uint4*>(w);
  const uint4 xv = *reinterpret_cast<const uint4*>(x);
  const bf16* wb = reinterpret_cast<const bf16*>(&wv);
  const bf16* xb = reinterpret_cast<const bf16*>(&xv);
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) acc = fmaf(__bfloat162float(wb[j]), __bfloat162float(xb[j]), acc);
  return acc;
}

}  // namespace ptt

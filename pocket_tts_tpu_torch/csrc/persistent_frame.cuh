// The backbone frame of a persistent B=1 decode launch, shared by the
// one-frame kernel (fused_backbone.cu) and the segment kernel
// (fused_segment.cu): the weight phases of the input projection and the L
// layers (`describe_backbone`), the two attention phases over (head, chunk)
// items (`attn_scores`, `attn_pv`), the shared-memory weight ring that feeds
// every weight phase, and the phase numbering of a frame.
//
// A frame's phases: 0 the input projection; per layer l, from 1 + 6 l: qkv,
// scores, pv, o, ff1, ff2; then what follows the backbone (the one-frame
// kernel's head, or the segment's flow head). Weight phases are counted
// apart: 0 the input projection, 1 + 4 l + (0 qkv, 1 o, 2 ff1, 3 ff2), then
// the weight phases after the backbone from 4 L + 1.

#pragma once

#include "persistent_decode.cuh"

namespace ptt {

using pd::kMaxChunks;

// The backbone's weight matrices, in the order of the row table
// (ops/persistent.py KINDS); the segment's flow matrices follow from K_BACKBONE.
enum BackboneKind { K_IN = 0, K_QKV, K_O, K_FF1, K_FF2, K_BACKBONE };

// The attention split over (head, chunk) items: chunk c of head h covers
// cache rows [c * chunk, min(C, (c + 1) * chunk)) and is item h * nch + c.
struct AttnSplit {
  float* part;   // [items, 64] partial outputs
  float* stats;  // [items, 2] chunk max, chunk sum of exp
  int chunk, nch;
};

// Phase ph of a frame: 1 scores, 2 pv, else 0, a weight phase whose index
// among the frame's weight phases is *wp.
__device__ __forceinline__ int phase_kind(int ph, int L, int* wp) {
  const int l = (ph - 1) / 6, q = (ph - 1) % 6;
  const bool layer = ph >= 1 && ph <= 6 * L;
  if (layer && (q == 1 || q == 2)) return q;
  *wp = ph == 0 ? 0 : layer ? 1 + 4 * l + (q == 0 ? 0 : q - 2) : ph - 2 * L;
  return 0;
}

// The GEMV of backbone weight phase wp (0 .. 4L) into x, which the caller
// zeroed (pd::Gemv{}): the input projection of x_in, then per layer qkv,
// out, ff1, ff2.
__device__ __forceinline__ void describe_backbone(const PttBackbone& a, const AttnSplit& sp, int wp,
                                                  const float* x_in, pd::Gemv& x) {
  const int E = a.E, FF = a.FF;
  if (wp == 0) {  // input projection of the previous latent (or BOS)
    x.pro.mode = pd::P_CAST; x.pro.x = x_in;
    x.epi.mode = pd::E_STORE; x.epi.out = a.x; x.epi.scale = a.s_in;
    x.w = a.win; x.kind = K_IN; x.K = a.ldim;
    return;
  }
  const int q = wp - 1, l = q / 4;
  const float* ln = a.ln + (size_t)l * 4 * E;
  switch (q % 4) {
    case 0:  // LN1 + QKV
      x.pro.mode = pd::P_NORM; x.pro.x = a.x; x.pro.w = ln; x.pro.b = ln + E; x.pro.eps = 1e-5f;
      x.epi.mode = pd::E_STORE; x.epi.out = a.qkv; x.epi.scale = a.sqkv + (size_t)l * 3 * E;
      x.w = a.wqkv + (size_t)l * 3 * E * E; x.kind = K_QKV; x.K = E;
      break;
    case 1:  // out-projection + residual; the prologue sums each head's partials in chunk order
      x.pro.mode = pd::P_PARTS; x.pro.part = sp.part; x.pro.chunks = sp.nch;
      x.epi.mode = pd::E_ADD; x.epi.out = a.x; x.epi.scale = a.so + (size_t)l * E;
      x.w = a.wo + (size_t)l * E * E; x.kind = K_O; x.K = E;
      break;
    case 2:  // LN2 + FF1 + GELU
      x.pro.mode = pd::P_NORM; x.pro.x = a.x; x.pro.w = ln + 2 * E; x.pro.b = ln + 3 * E; x.pro.eps = 1e-5f;
      x.epi.mode = pd::E_GELU_BF16; x.epi.outb = a.hidden; x.epi.scale = a.s1 + (size_t)l * FF;
      x.w = a.w1 + (size_t)l * FF * E; x.kind = K_FF1; x.K = E;
      break;
    default:  // FF2 + residual
      x.pro.mode = pd::P_BF16; x.pro.xb = a.hidden;
      x.epi.mode = pd::E_ADD; x.epi.out = a.x; x.epi.scale = a.s2 + (size_t)l * E;
      x.w = a.w2 + (size_t)l * E * FF; x.kind = K_FF2; x.K = FF;
      break;
  }
}

// Attention scores of layer l for this block's (head, chunk) items [it0, it1):
// RoPE of q (and, for chunk 0, of k), the chunk's scores into sc (the self
// score at [chunk]), the chunk max and sum of exp published to stats, and
// (chunk 0) the new (k, v) row written at widx.
__device__ __forceinline__ void attn_scores(const PttBackbone& a, const AttnSplit& g, int l, int it0, int it1,
                                            int qpos, int widx, float* sc, float* red, float* qf, float* kf,
                                            float* vf) {
  constexpr int d = kHeadDim, kRowsPerPass = pd::kThreads / 8;
  const int tid = threadIdx.x, E = a.E, H = a.H, C = a.C, sub = tid & 7;
  const float scale = rsqrtf((float)d);
  bf16* kc = a.k[l];
  bf16* vc = a.v[l];
  for (int it = it0; it < it1; ++it) {
    const int h = it / g.nch, c = it - h * g.nch;
    const int r0 = c * g.chunk, r1 = min(C, r0 + g.chunk);
    float* sci = sc + (it - it0) * (g.chunk + 4);
    const int passes = (r1 - r0 + kRowsPerPass - 1) / kRowsPerPass;
    for (int pass = 0; pass < passes; ++pass) {
      // The row's slot_pos and K slice are loaded together (K of a row that
      // turns out invalid is selected away), q rotated meanwhile.
      const int r = r0 + pass * kRowsPerPass + (tid >> 3);
      int sp = -1;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      if (r < r1) {
        sp = pd::ldcg(a.slot_pos + r);
        kv = pd::ldcg16(kc + ((size_t)r * H + h) * d + sub * 8);
      }
      if (pass == 0) {
        if (tid < d / 2) {
          const float freq = expf((float)tid * a.rope_coef);
          const float ang = (float)qpos * freq;
          const float cs = cosf(ang), sn = sinf(ang);
          const float* q = a.qkv + h * d;
          const float q0 = pd::ldcg(q + 2 * tid), q1 = pd::ldcg(q + 2 * tid + 1);
          qf[2 * tid] = bf16_round(__fsub_rn(__fmul_rn(q0, cs), __fmul_rn(q1, sn)));
          qf[2 * tid + 1] = bf16_round(__fadd_rn(__fmul_rn(q0, sn), __fmul_rn(q1, cs)));
          if (c == 0) {
            const float* k = a.qkv + E + h * d;
            const float k0 = pd::ldcg(k + 2 * tid), k1 = pd::ldcg(k + 2 * tid + 1);
            kf[2 * tid] = bf16_round(__fsub_rn(__fmul_rn(k0, cs), __fmul_rn(k1, sn)));
            kf[2 * tid + 1] = bf16_round(__fadd_rn(__fmul_rn(k0, sn), __fmul_rn(k1, cs)));
          }
        }
        if (c == 0 && tid >= 64 && tid < 64 + d) vf[tid - 64] = bf16_round(pd::ldcg(a.qkv + 2 * E + h * d + tid - 64));
        __syncthreads();
        if (c == 0 && tid < 32) {
          float p = qf[tid] * kf[tid] + qf[tid + 32] * kf[tid + 32];
          p = warp_sum(p);
          if (tid == 0) sci[g.chunk] = p * scale;
        }
      }
      const bool valid = sp >= 0 && sp < qpos && r != widx;
      const bf16* kb = reinterpret_cast<const bf16*>(&kv);
      float p = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) p = fmaf(__bfloat162float(kb[j]), qf[sub * 8 + j], p);
      p += __shfl_xor_sync(0xffffffffu, p, 4);
      p += __shfl_xor_sync(0xffffffffu, p, 2);
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      if (r < r1 && sub == 0) sci[r - r0] = valid ? p * scale : -INFINITY;
    }
    if (c == 0 && tid < d) {  // row widx is masked from every read of this frame
      kc[((size_t)widx * H + h) * d + tid] = __float2bfloat16(kf[tid]);
      vc[((size_t)widx * H + h) * d + tid] = __float2bfloat16(vf[tid]);
    }
    __syncthreads();
    float m = c == 0 ? sci[g.chunk] : -INFINITY;
    for (int i = tid; i < r1 - r0; i += pd::kThreads) m = fmaxf(m, sci[i]);
    m = pd::block_max_i(m, red);
    float sum = 0.f;
    for (int i = tid; i < r1 - r0; i += pd::kThreads) {
      const float v = sci[i];
      if (v != -INFINITY) sum += expf(v - m);
    }
    sum = pd::block_sum_i(sum, red);
    if (c == 0) sum += expf(sci[g.chunk] - m);
    if (tid == 0) __stcg(reinterpret_cast<float2*>(g.stats) + it, make_float2(m, sum));
    __syncthreads();
  }
}

// Attention PV of layer l for the same items, their scores still in sc: the
// head's global max and denominator from its chunks' statistics (in chunk
// order), the weights rounded to bf16, and the item's [64] partial output
// (chunk 0's with the new row's term) published to part.
__device__ __forceinline__ void attn_pv(const PttBackbone& a, const AttnSplit& g, int l, int it0, int it1, float* sc,
                                        float (*pvr)[kHeadDim]) {
  constexpr int d = kHeadDim, kRowsPerPass = pd::kThreads / 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, E = a.E, H = a.H, C = a.C, sub = tid & 7;
  const bf16* vc = a.v[l];
  for (int it = it0; it < it1; ++it) {
    const int h = it / g.nch, c = it - h * g.nch;
    const int r0 = c * g.chunk, r1 = min(C, r0 + g.chunk);
    const float* sci = sc + (it - it0) * (g.chunk + 4);
    const float2* st = reinterpret_cast<const float2*>(g.stats) + h * g.nch;
    const float v_self = c == 0 && tid < d ? bf16_round(pd::ldcg(a.qkv + 2 * E + h * d + tid)) : 0.f;
    float2 cs[kMaxChunks];
#pragma unroll
    for (int c2 = 0; c2 < kMaxChunks; ++c2) cs[c2] = c2 < g.nch ? __ldcg(st + c2) : make_float2(-INFINITY, 0.f);
    float M = -INFINITY;
#pragma unroll
    for (int c2 = 0; c2 < kMaxChunks; ++c2) M = fmaxf(M, cs[c2].x);
    float denom = 0.f;
#pragma unroll
    for (int c2 = 0; c2 < kMaxChunks; ++c2)
      if (cs[c2].y > 0.f) denom += cs[c2].y * expf(cs[c2].x - M);
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
    for (int r = r0 + (tid >> 3); r < r1; r += kRowsPerPass) {
      const float s = sci[r - r0];
      if (s != -INFINITY) {
        const uint4 vv = pd::ldcg16(vc + ((size_t)r * H + h) * d + sub * 8);
        const float w = bf16_round(expf(s - M) / denom);
        const bf16* vb = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = fmaf(w, __bfloat162float(vb[j]), acc[j]);
      }
    }
    // Sum the warp's four row groups, then the warps in order.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], 8);
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], 16);
    }
    if (lane < 8) {
#pragma unroll
      for (int j = 0; j < 8; ++j) pvr[warp][sub * 8 + j] = acc[j];
    }
    __syncthreads();
    if (tid < d) {
      float o = 0.f;
      for (int w = 0; w < pd::kWarps; ++w) o += pvr[w][tid];
      if (c == 0) o += bf16_round(expf(sci[g.chunk] - M) / denom) * v_self;
      __stcg(g.part + (size_t)it * d + tid, o);
    }
    __syncthreads();
  }
}

// The weight ring: two slots of slot_bytes at offset 0 of shared memory.
// Weight phase j's rows of this block lie in slot j % 2 once mbarrier j % 2
// completes its phase (j / 2) % 2. Thread 0 copies them (one bulk copy per
// matrix) in the grid barrier after weight phase j - 2, the slot's last
// reader, so they travel while weight phase j - 1 runs.
struct WeightRing {
  unsigned char* smem;
  uint32_t bar0;
  int slot_bytes, total;  // total: weight phases of the launch
  const int* rows;        // this block's [lo, hi) of each matrix kind

  __device__ unsigned char* slot(int j) const { return smem + (j & 1) * slot_bytes; }
  __device__ uint32_t bar(int j) const { return bar0 + (j & 1) * 8; }
  __device__ uint32_t parity(int j) const { return (uint32_t)((j >> 1) & 1); }

  // describe(j, d) fills the GEMVs of weight phase j into d and returns how many.
  template <class Describe>
  __device__ __forceinline__ void issue(int j, Describe&& describe) const {
    if (j >= total) return;
    pd::Gemv d[2];
    const int n = describe(j, d);
    uint32_t row_bytes[2], bytes[2] = {0u, 0u};
    for (int m = 0; m < n; ++m) {
      row_bytes[m] = (uint32_t)d[m].K * (d[m].bf16w ? 2u : 1u);
      bytes[m] = (uint32_t)(rows[2 * d[m].kind + 1] - rows[2 * d[m].kind]) * row_bytes[m];
    }
    pd::fence_proxy_async();
    pd::mbar_expect(bar(j), bytes[0] + bytes[1]);
    for (int m = 0; m < n; ++m) {
      const unsigned char* src = static_cast<const unsigned char*>(d[m].w) + (size_t)rows[2 * d[m].kind] * row_bytes[m];
      if (bytes[m]) pd::bulk_copy(pd::smem_addr(slot(j) + d[m].woff), src, bytes[m], bar(j));
    }
  }
};

// Allow `kernel` smem bytes of dynamic shared memory on the current device;
// set_for[device] keeps the largest size allowed so far.
static inline int set_shared_bytes(const void* kernel, int smem, int (&set_for)[64]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64 && smem > set_for[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    set_for[dev] = smem;
  }
  return 0;
}

}  // namespace ptt

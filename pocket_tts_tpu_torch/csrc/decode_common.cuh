// Shared device code of the two B=1 FlowLM decode kernels
// (fused_backbone.cu, fused_segment.cu): weight-streaming GEMVs with fused
// prologues/epilogues, one-query attention over the slot-major KV cache, and
// the FlowLM head. Built with nvcc for sm_90a into plain-C shared libraries
// (see pocket_tts_tpu_torch/ops/_cuda.py).
//
// What bounds a frame on the H100: at B=1 every weight is read once per frame
// and used for one multiply-add, so the frame is a stream of weight bytes —
// 75.5 MB of int8 backbone weights (6 layers x 12 E*E chunks) plus, in the
// segment kernel, about 20 MB of bf16 flow-head weights. The design answer
// here is the simplest one that is right: each GEMV gives one output row to
// one warp, which reads the row with 16-byte loads, and spreads the rows over
// hundreds of blocks so every SM streams weights; activations (at most 8 KB)
// sit in shared memory, normalised/cast once per block in the prologue; the
// epilogue applies the int8 scale, bias, GELU/SiLU or residual in registers.
// Launch overhead (about 32-48 launches per frame) is the known cost of this
// first form; one launch per frame or segment is later work.

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
  float* x; float* qkv; float* attn;      // scratch [E], [3E], [E]
  bf16* hidden; float* h;                 // scratch [FF], [E]
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

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kAttnThreads = 256;
constexpr int kHeadDim = 64;  // attention layout: 8 lanes x 8 dims per row, 4 x 64 PV groups

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

// Block-wide reductions; every thread gets the result. `red` holds >= 32 floats.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < nw; ++i) t += red[i];
  return t;
}

__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = red[0];
  for (int i = 1; i < nw; ++i) t = fmaxf(t, red[i]);
  return t;
}

__device__ __forceinline__ float bf16_round(float v) { return __bfloat162float(__float2bfloat16(v)); }
__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }
__device__ __forceinline__ float gelu_erf(float v) { return 0.5f * v * (1.f + erff(v * 0.7071067811865476f)); }

// ---------------------------------------------------------------- GEMV
// y[r] = sum_k W[r, k] * xs[k] for r < N, W row-major [N, K] (int8 codes or
// bf16), xs the bf16-rounded activation built by the prologue. Products of
// two bf16-exact values are exact in float32; sums accumulate in float32.

enum ProMode { PRO_CAST = 0, PRO_LN = 1, PRO_BF16 = 2, PRO_SILU = 3, PRO_ADALN = 4, PRO_SELECT = 5 };
enum EpiMode { EPI_STORE = 0, EPI_ADD = 1, EPI_GELU_BF16 = 2, EPI_SILU = 3, EPI_FINAL = 4 };

struct Pro {
  int mode;
  const float* x;                     // float32 input [K]
  const bf16* xb;                     // PRO_BF16 input [K]
  const float* w; const float* b;     // PRO_LN / PRO_ADALN affine (may be null)
  float eps;
  const float* shift; const float* scale;  // PRO_ADALN modulation [K]
  const float* alt; int sel;          // PRO_SELECT: sel ? alt : x
};

struct Epi {
  int mode;
  float* out; bf16* outb;
  const float* scale;  // per-row int8 scale (null: 1)
  const float* bias;   // per-row bias (null: 0)
  const float* bias2;  // second per-row bias (null: 0)
  const float* gate;   // EPI_ADD: out += gate * v (null: out += v)
  const float* base;   // EPI_FINAL: out = base + v
};

// LayerNorm statistics of x[0..K): mean and rsqrt(var + eps), two passes.
__device__ void ln_stats(const float* x, int K, float eps, float* red, float* mean, float* rstd) {
  float s = 0.f;
  for (int i = threadIdx.x; i < K; i += blockDim.x) s += x[i];
  const float m = block_sum(s, red) / (float)K;
  float q = 0.f;
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    const float c = x[i] - m;
    q += c * c;
  }
  const float var = block_sum(q, red) / (float)K;
  *mean = m;
  *rstd = rsqrtf(var + eps);
}

__device__ void prologue(const Pro& p, int K, bf16* xs, float* red) {
  const int tid = threadIdx.x, nt = blockDim.x;
  switch (p.mode) {
    case PRO_CAST:
      for (int i = tid; i < K; i += nt) xs[i] = __float2bfloat16(p.x[i]);
      break;
    case PRO_BF16:
      for (int i = tid; i < K; i += nt) xs[i] = p.xb[i];
      break;
    case PRO_SILU:
      for (int i = tid; i < K; i += nt) xs[i] = __float2bfloat16(silu(p.x[i]));
      break;
    case PRO_SELECT: {
      const float* src = p.sel ? p.alt : p.x;
      for (int i = tid; i < K; i += nt) xs[i] = __float2bfloat16(src[i]);
      break;
    }
    case PRO_LN:
    case PRO_ADALN: {
      float mean, rstd;
      ln_stats(p.x, K, p.eps, red, &mean, &rstd);
      for (int i = tid; i < K; i += nt) {
        float y = (p.x[i] - mean) * rstd;
        if (p.w) y = y * p.w[i];
        if (p.b) y = y + p.b[i];
        if (p.mode == PRO_ADALN) y = y * (1.f + p.scale[i]) + p.shift[i];
        xs[i] = __float2bfloat16(y);
      }
      break;
    }
  }
}

__device__ __forceinline__ void epilogue(const Epi& e, int r, float acc) {
  float v = acc;
  if (e.scale) v = v * e.scale[r];
  if (e.bias) v = v + e.bias[r];
  if (e.bias2) v = v + e.bias2[r];
  switch (e.mode) {
    case EPI_STORE: e.out[r] = v; break;
    case EPI_ADD: e.out[r] = e.out[r] + (e.gate ? e.gate[r] * v : v); break;
    case EPI_GELU_BF16: e.outb[r] = __float2bfloat16(gelu_erf(v)); break;
    case EPI_SILU: e.out[r] = silu(v); break;
    case EPI_FINAL: e.out[r] = e.base[r] + v; break;
  }
}

// 16 weights per 16-byte load for int8, 8 for bf16.
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

template <typename WT>
struct VecWidth { static constexpr int value = 16; };
template <>
struct VecWidth<bf16> { static constexpr int value = 8; };

// One warp per output row; rows spread over the grid. K % VecWidth == 0 and
// 16-byte aligned rows are the caller's contract (checked in Python).
template <typename WT>
__global__ void __launch_bounds__(kThreads) gemv_kernel(const WT* __restrict__ W, int N, int K, Pro pro, Epi epi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  __shared__ float red[32];
  prologue(pro, K, xs, red);
  __syncthreads();
  constexpr int V = VecWidth<WT>::value;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int r = blockIdx.x * nw + warp; r < N; r += gridDim.x * nw) {
    const WT* wr = W + (size_t)r * K;
    float acc = 0.f;
    for (int i = lane * V; i < K; i += 32 * V) acc += dot16(wr + i, xs + i);
    acc = warp_sum(acc);
    if (lane == 0) epilogue(epi, r, acc);
  }
}

template <typename WT>
static cudaError_t gemv(const WT* W, int N, int K, const Pro& pro, const Epi& epi, cudaStream_t st) {
  const int blocks = (N + kWarps - 1) / kWarps;
  gemv_kernel<WT><<<blocks, kThreads, (size_t)K * sizeof(bf16), st>>>(W, N, K, pro, epi);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- attention
// One block per head. qkv [3E] float32 (q | k | v, head-major); the cache is
// [C, H, d] bf16 slot-major. Rotates q and the new k (interleaved pairs),
// attends over the cache rows valid for this query (0 <= slot_pos < qpos,
// excluding row widx, which this frame overwrites) plus the new row itself,
// then writes the new (k, v) row at widx. Roundings mirror the JAX package:
// q, k, v and the softmax weights are rounded to bf16, scores and sums are
// float32.
__global__ void __launch_bounds__(kAttnThreads) attn_decode_kernel(
    const float* __restrict__ qkv, bf16* kc, bf16* vc, const int* __restrict__ slot_pos,
    int C, int H, int qpos, int widx, float rope_coef, float* __restrict__ out) {
  constexpr int d = kHeadDim;
  extern __shared__ float sc[];  // [C] scores, then softmax weights
  __shared__ float qf[d], kf[d], vf[d], pv[4][d];
  __shared__ float red[32];
  __shared__ float s_self_sh;
  const int h = blockIdx.x, tid = threadIdx.x;
  const int E = H * d;
  const float scale = rsqrtf((float)d);

  if (tid < d / 2) {
    const float freq = expf((float)tid * rope_coef);
    const float ang = (float)qpos * freq;
    const float c = cosf(ang), s = sinf(ang);
    const float* q = qkv + h * d;
    const float* k = qkv + E + h * d;
    const float q0 = q[2 * tid], q1 = q[2 * tid + 1];
    const float k0 = k[2 * tid], k1 = k[2 * tid + 1];
    qf[2 * tid] = bf16_round(__fsub_rn(__fmul_rn(q0, c), __fmul_rn(q1, s)));
    qf[2 * tid + 1] = bf16_round(__fadd_rn(__fmul_rn(q0, s), __fmul_rn(q1, c)));
    kf[2 * tid] = bf16_round(__fsub_rn(__fmul_rn(k0, c), __fmul_rn(k1, s)));
    kf[2 * tid + 1] = bf16_round(__fadd_rn(__fmul_rn(k0, s), __fmul_rn(k1, c)));
  }
  if (tid < d) vf[tid] = bf16_round(qkv[2 * E + h * d + tid]);
  __syncthreads();
  if (tid < 32) {
    float p = qf[tid] * kf[tid] + qf[tid + 32] * kf[tid + 32];
    p = warp_sum(p);
    if (tid == 0) s_self_sh = p * scale;
  }

  // Scores: 8 lanes per row, 8 dims (16 bytes) per lane.
  const int sub = tid & 7;
  for (int c0 = tid >> 3; c0 < C; c0 += kAttnThreads / 8) {
    const int sp = slot_pos[c0];
    const bool valid = sp >= 0 && sp < qpos && c0 != widx;
    float p = 0.f;
    if (valid) {
      const uint4 kv = *reinterpret_cast<const uint4*>(kc + ((size_t)c0 * H + h) * d + sub * 8);
      const bf16* kb = reinterpret_cast<const bf16*>(&kv);
#pragma unroll
      for (int j = 0; j < 8; ++j) p = fmaf(__bfloat162float(kb[j]), qf[sub * 8 + j], p);
    }
    p += __shfl_xor_sync(0xffffffffu, p, 4);
    p += __shfl_xor_sync(0xffffffffu, p, 2);
    p += __shfl_xor_sync(0xffffffffu, p, 1);
    if (sub == 0) sc[c0] = valid ? p * scale : -1e9f;
  }
  __syncthreads();
  const float s_self = s_self_sh;
  float m = s_self;
  for (int c0 = tid; c0 < C; c0 += kAttnThreads) m = fmaxf(m, sc[c0]);
  m = block_max(m, red);
  float l = 0.f;
  for (int c0 = tid; c0 < C; c0 += kAttnThreads) {
    const float e = expf(sc[c0] - m);
    sc[c0] = e;
    l += e;
  }
  const float e_self = expf(s_self - m);
  const float denom = block_sum(l, red) + e_self;
  for (int c0 = tid; c0 < C; c0 += kAttnThreads) sc[c0] = bf16_round(sc[c0] / denom);
  __syncthreads();

  // PV: 4 groups of 64 threads, thread j owns output dim j.
  const int j = tid & (d - 1), g = tid / d;
  float acc = 0.f;
  for (int c0 = g; c0 < C; c0 += kAttnThreads / d) {
    const float w = sc[c0];
    if (w != 0.f) acc = fmaf(w, __bfloat162float(vc[((size_t)c0 * H + h) * d + j]), acc);
  }
  pv[g][j] = acc;
  __syncthreads();
  if (tid < d) {
    const float w_self = bf16_round(e_self / denom);
    out[h * d + tid] = (pv[0][tid] + pv[1][tid]) + (pv[2][tid] + pv[3][tid]) + w_self * vf[tid];
    // The new row lands after every read of this head's columns (row widx was
    // masked above); each block writes only its own head's d columns.
    kc[((size_t)widx * H + h) * d + tid] = __float2bfloat16(kf[tid]);
    vc[((size_t)widx * H + h) * d + tid] = __float2bfloat16(vf[tid]);
  }
}

// out_norm (LayerNorm eps 1e-5) -> h, the EOS logit, and the slot_pos append.
__global__ void __launch_bounds__(kThreads) head_out_kernel(
    const float* __restrict__ x, const float* __restrict__ out_norm, const float* __restrict__ eos_w,
    const float* __restrict__ eos_b, int E, int* slot_pos, int widx, int qpos, float* h, float* eos) {
  __shared__ float red[32];
  float mean, rstd;
  ln_stats(x, E, 1e-5f, red, &mean, &rstd);
  float e = 0.f;
  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    const float hn = (x[i] - mean) * rstd * out_norm[i] + out_norm[E + i];
    h[i] = hn;
    e += hn * eos_w[i];
  }
  e = block_sum(e, red);
  if (threadIdx.x == 0) {
    eos[0] = e + eos_b[0];
    slot_pos[widx] = qpos;
  }
}

#define PTT_TRY(expr)                  \
  do {                                 \
    cudaError_t _e = (expr);           \
    if (_e != cudaSuccess) return _e;  \
  } while (0)

// One backbone frame: input projection of `in_x` (or the BOS embedding when
// sel_bos), L layers with in-place KV appends at widx, then the head.
static cudaError_t backbone_frame(const PttBackbone& a, const float* in_x, int sel_bos, int qpos, int widx,
                                  float* h_out, float* eos_out, cudaStream_t st) {
  const int E = a.E, FF = a.FF, L = a.L;
  {
    Pro p{}; p.mode = PRO_SELECT; p.x = in_x; p.alt = a.bos; p.sel = sel_bos;
    Epi e{}; e.mode = EPI_STORE; e.out = a.x; e.scale = a.s_in;
    PTT_TRY(gemv<int8_t>(a.win, E, a.ldim, p, e, st));
  }
  for (int l = 0; l < L; ++l) {
    const float* ln = a.ln + (size_t)l * 4 * E;
    {
      Pro p{}; p.mode = PRO_LN; p.x = a.x; p.w = ln; p.b = ln + E; p.eps = 1e-5f;
      Epi e{}; e.mode = EPI_STORE; e.out = a.qkv; e.scale = a.sqkv + (size_t)l * 3 * E;
      PTT_TRY(gemv<int8_t>(a.wqkv + (size_t)l * 3 * E * E, 3 * E, E, p, e, st));
    }
    attn_decode_kernel<<<a.H, kAttnThreads, (size_t)a.C * sizeof(float), st>>>(
        a.qkv, a.k[l], a.v[l], a.slot_pos, a.C, a.H, qpos, widx, a.rope_coef, a.attn);
    PTT_TRY(cudaGetLastError());
    {
      Pro p{}; p.mode = PRO_CAST; p.x = a.attn;
      Epi e{}; e.mode = EPI_ADD; e.out = a.x; e.scale = a.so + (size_t)l * E;
      PTT_TRY(gemv<int8_t>(a.wo + (size_t)l * E * E, E, E, p, e, st));
    }
    {
      Pro p{}; p.mode = PRO_LN; p.x = a.x; p.w = ln + 2 * E; p.b = ln + 3 * E; p.eps = 1e-5f;
      Epi e{}; e.mode = EPI_GELU_BF16; e.outb = a.hidden; e.scale = a.s1 + (size_t)l * FF;
      PTT_TRY(gemv<int8_t>(a.w1 + (size_t)l * FF * E, FF, E, p, e, st));
    }
    {
      Pro p{}; p.mode = PRO_BF16; p.xb = a.hidden;
      Epi e{}; e.mode = EPI_ADD; e.out = a.x; e.scale = a.s2 + (size_t)l * E;
      PTT_TRY(gemv<int8_t>(a.w2 + (size_t)l * E * FF, E, FF, p, e, st));
    }
  }
  head_out_kernel<<<1, kThreads, 0, st>>>(a.x, a.out_norm, a.eos_w, a.eos_b, E, a.slot_pos, widx, qpos,
                                          h_out, eos_out);
  return cudaGetLastError();
}

}  // namespace ptt

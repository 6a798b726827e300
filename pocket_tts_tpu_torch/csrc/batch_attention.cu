// Hopper port of the JAX package's batch_decode_attention
// (pocket_tts_tpu/ops/batch_attention.py:batch_decode_attention, Pallas
// kernel `_kernel`): one query per stream (T == 1) over the slot-major KV
// cache [B, C, H, d], B > 1, reading rows [0, R) only. A row is valid for
// stream b when 0 <= slot_pos[b, r] <= qpos[b]; a stream with no valid row
// outputs 0. int8 caches carry one float32 scale per row, shared by all H
// heads: the K scale multiplies the scores, the V scale the softmax weights.
//
// Bound on the H100: the K and V rows, read once. bf16 at B=64, R=512,
// H*d=1024 is 2*B*R*H*d*2 = 134 MB, 40 us at 3.35 TB/s; int8 is 67 MB plus
// 0.26 MB of scales, 20 us. The batch decode makes one call per layer and
// step (6 per frame at b6369a24).
//
// What the design does about it: split-R flash decoding in two passes.
// Grid (R/128 splits, H, B); each block owns 128 rows of one head, whose
// row slices (d = 64 values) sit 16-byte aligned in the cache, so each lane
// issues 16-byte loads — all of its rows' loads before any arithmetic — and
// invalid rows are never read. int8 codes convert in registers (exact in
// bf16).
//   1. scores: q (rounded to bf16, or float32 for a float32 cache) . k in
//      float32, scaled; invalid rows -inf; per split (max, sum of exp).
//   2. pv: every block combines the splits' (max, sum) into the stream's
//      softmax, forms the normalised weight of each of its rows, times the V
//      scale, rounded to bf16 as _sdpa_slots rounds it, and accumulates
//      weight * v in float32 into a per-split partial output. A stream
//      whose splits saw no valid row writes 0.
//   3. combine: the partial outputs of the splits are summed in order.
// Pass 2 reads V once and pass 1 reads K once, so the bytes stay the bound's;
// the float32 scores scratch ([B, H, R], 2 MB at B=64, R=512) is the price
// of rounding the normalised weights exactly like the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kD = 64;         // head dim
constexpr int kRows = 128;     // rows per split (R % 128 == 0)
constexpr int kThreads = 128;  // threads per block of passes 1 and 2

// 16 bytes of cache elements -> float.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& u, float* o) {
    const float* f = reinterpret_cast<const float*>(&u);
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = f[i];
  }
  __device__ static float round(float x) { return x; }  // float32 cache: no operand rounding
};
template <>
struct Vec<bf16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& u, float* o) {
    const bf16* f = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = __bfloat162float(f[i]);
  }
  __device__ static float round(float x) { return __bfloat162float(__float2bfloat16(x)); }
};
template <>
struct Vec<int8_t> {
  static constexpr int N = 16;
  __device__ static void unpack(const uint4& u, float* o) {
    const int8_t* f = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = (float)f[i];
  }
  // int8 rows are computed as bf16, like _sdpa_slots.
  __device__ static float round(float x) { return __bfloat162float(__float2bfloat16(x)); }
};

// Pass 1. Each row's d values are LPR lanes x N elements; a block covers RPI
// rows per step and ITER steps.
template <typename T>
__global__ void __launch_bounds__(kThreads) scores_kernel(
    const float* __restrict__ q, const T* __restrict__ k, const int* __restrict__ slot_pos, int sp_stride,
    const int* __restrict__ qpos, const float* __restrict__ k_scale, int sc_stride, int C, int H, int R,
    float* __restrict__ scores, float2* __restrict__ part) {
  constexpr int N = Vec<T>::N, LPR = kD / N, RPI = kThreads / LPR, ITER = kRows / RPI;
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z, NS = gridDim.x;
  const int tid = threadIdx.x, sub = tid % LPR, rsub = tid / LPR;
  __shared__ float ssc[kRows];
  const int qp = qpos[b];
  const int row0 = s * kRows;

  bool valid[ITER];
  uint4 buf[ITER];
#pragma unroll
  for (int i = 0; i < ITER; ++i) {
    const int r = row0 + i * RPI + rsub;
    const int sp = slot_pos[(size_t)b * sp_stride + r];
    valid[i] = sp >= 0 && sp <= qp;
    buf[i] = make_uint4(0u, 0u, 0u, 0u);
    if (valid[i])
      buf[i] = __ldg(reinterpret_cast<const uint4*>(k + (((size_t)b * C + r) * H + h) * kD) + sub);
  }
  float qf[N];
  const float* qb = q + ((size_t)b * H + h) * kD + sub * N;
#pragma unroll
  for (int j = 0; j < N; ++j) qf[j] = Vec<T>::round(qb[j]);
  const float inv_sqrt_d = 0.125f;  // 1 / sqrt(64)
#pragma unroll
  for (int i = 0; i < ITER; ++i) {
    float kv[N];
    Vec<T>::unpack(buf[i], kv);
    float p = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) p = fmaf(kv[j], qf[j], p);
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
    if (sub == 0) {
      const int r = row0 + i * RPI + rsub;
      float sv = -INFINITY;
      if (valid[i]) sv = k_scale ? p * (k_scale[(size_t)b * sc_stride + r] * inv_sqrt_d) : p * inv_sqrt_d;
      ssc[i * RPI + rsub] = sv;
    }
  }
  __syncthreads();
  scores[((size_t)b * H + h) * R + row0 + tid] = ssc[tid];  // kThreads == kRows
  if (tid < 32) {
    float m = -INFINITY;
    for (int j = tid; j < kRows; j += 32) m = fmaxf(m, ssc[j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.f;
    if (m != -INFINITY)
      for (int j = tid; j < kRows; j += 32) l += expf(ssc[j] - m);  // exp(-inf) = 0
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (tid == 0) part[((size_t)b * H + h) * NS + s] = make_float2(m, l);
  }
}

// Pass 2.
template <typename T>
__global__ void __launch_bounds__(kThreads) pv_kernel(
    const T* __restrict__ v, const float* __restrict__ v_scale, int sc_stride, const float* __restrict__ scores,
    const float2* __restrict__ part, int C, int H, int R, float* __restrict__ part_out) {
  constexpr int N = Vec<T>::N, LPR = kD / N, RPI = kThreads / LPR, ITER = kRows / RPI;
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z, NS = gridDim.x;
  const int tid = threadIdx.x, sub = tid % LPR, rsub = tid / LPR;
  const int row0 = s * kRows;
  __shared__ float sw[kRows];
  __shared__ float red[RPI][kD];
  __shared__ float stat[2];
  float* out = part_out + (((size_t)b * H + h) * NS + s) * kD;

  if (tid < 32) {  // the stream's softmax max and denominator from the splits
    const float2* ps = part + ((size_t)b * H + h) * NS;
    float m = -INFINITY;
    for (int i = tid; i < NS; i += 32) m = fmaxf(m, ps[i].x);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.f;
    if (m != -INFINITY)
      for (int i = tid; i < NS; i += 32)
        if (ps[i].x != -INFINITY) l += ps[i].y * expf(ps[i].x - m);  // a split with no valid row adds 0
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (tid == 0) {
      stat[0] = m;
      stat[1] = l;
    }
  }
  __syncthreads();
  const float m = stat[0], l = stat[1];
  if (m == -INFINITY) {  // no valid row in the whole stream
    if (tid < kD) out[tid] = 0.f;
    return;
  }
  {
    const int r = row0 + tid;
    const float sc = scores[((size_t)b * H + h) * R + r];
    float w = 0.f;
    if (sc != -INFINITY) {
      w = __fdiv_rn(expf(sc - m), l);
      if (v_scale) w = w * v_scale[(size_t)b * sc_stride + r];
      w = Vec<T>::round(w);
    }
    sw[tid] = w;
  }
  __syncthreads();

  uint4 buf[ITER];
#pragma unroll
  for (int i = 0; i < ITER; ++i) {
    const int j = i * RPI + rsub;
    buf[i] = make_uint4(0u, 0u, 0u, 0u);
    if (sw[j] != 0.f)
      buf[i] = __ldg(reinterpret_cast<const uint4*>(v + (((size_t)b * C + row0 + j) * H + h) * kD) + sub);
  }
  float acc[N];
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n] = 0.f;
#pragma unroll
  for (int i = 0; i < ITER; ++i) {
    const float w = sw[i * RPI + rsub];
    float vv[N];
    Vec<T>::unpack(buf[i], vv);
#pragma unroll
    for (int n = 0; n < N; ++n) acc[n] = fmaf(w, vv[n], acc[n]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) red[rsub][sub * N + n] = acc[n];
  __syncthreads();
  if (tid < kD) {
    float t = 0.f;
#pragma unroll
    for (int g = 0; g < RPI; ++g) t += red[g][tid];
    out[tid] = t;
  }
}

// Pass 3: out[b, h, :] = sum over the splits of the partial outputs.
__global__ void __launch_bounds__(kD) combine_kernel(const float* __restrict__ part_out, int NS,
                                                     float* __restrict__ out) {
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x, j = threadIdx.x;
  const float* p = part_out + ((size_t)b * H + h) * NS * kD + j;
  float t = 0.f;
  for (int s = 0; s < NS; ++s) t += p[(size_t)s * kD];
  out[((size_t)b * H + h) * kD + j] = t;
}

template <typename T>
cudaError_t launch(const float* q, const void* k, const void* v, const int* slot_pos, int sp_stride,
                   const int* qpos, const float* k_scale, const float* v_scale, int sc_stride, int B, int C,
                   int H, int R, float* scores, float2* part, float* part_out, float* out, cudaStream_t st) {
  const int NS = R / kRows;
  const dim3 grid(NS, H, B);
  scores_kernel<T><<<grid, kThreads, 0, st>>>(q, static_cast<const T*>(k), slot_pos, sp_stride, qpos, k_scale,
                                              sc_stride, C, H, R, scores, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  pv_kernel<T><<<grid, kThreads, 0, st>>>(static_cast<const T*>(v), v_scale, sc_stride, scores, part, C, H, R,
                                          part_out);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  combine_kernel<<<dim3(H, B), kD, 0, st>>>(part_out, NS, out);
  return cudaGetLastError();
}

}  // namespace

// kind: 0 float32, 1 bf16, 2 int8 cache. q [B, H, 64] float32; k, v
// [B, C, H, 64]; slot_pos rows of stride sp_stride (R used); qpos [B];
// k_scale / v_scale rows of stride sc_stride (int8 only, else null);
// scratch: scores [B, H, R], part [B, H, R/128] float2, part_out
// [B, H, R/128, 64]; out [B, H, 64] float32. R % 128 == 0, R <= C.
extern "C" int ptt_batch_decode_attention(const float* q, const void* k, const void* v, int kind,
                                          const int* slot_pos, int sp_stride, const int* qpos,
                                          const float* k_scale, const float* v_scale, int sc_stride, int B,
                                          int C, int H, int R, float* scores, float* part, float* part_out,
                                          float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float2* p2 = reinterpret_cast<float2*>(part);
  switch (kind) {
    case 0:
      return (int)launch<float>(q, k, v, slot_pos, sp_stride, qpos, nullptr, nullptr, 0, B, C, H, R, scores, p2,
                                part_out, out, st);
    case 1:
      return (int)launch<bf16>(q, k, v, slot_pos, sp_stride, qpos, nullptr, nullptr, 0, B, C, H, R, scores, p2,
                               part_out, out, st);
    case 2:
      return (int)launch<int8_t>(q, k, v, slot_pos, sp_stride, qpos, k_scale, v_scale, sc_stride, B, C, H, R,
                                 scores, p2, part_out, out, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

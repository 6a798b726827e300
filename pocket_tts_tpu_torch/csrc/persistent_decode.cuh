// Building blocks of a persistent B=1 decode kernel: one cooperative launch
// whose blocks (one per SM) walk a fixed list of phases separated by grid
// barriers. Both B=1 kernels (fused_backbone.cu, fused_segment.cu) are built
// from these pieces and from the backbone frame of persistent_frame.cuh.
//
//  - GridBarrier: a monotonic 64-bit arrival counter in device memory that the
//    caller owns (zeroed once, never reset). Each launch adds exactly kEpoch
//    to it in all, so a block finds its launch's base by rounding the counter
//    down to a multiple of kEpoch when it starts: no reset kernel and no
//    count kept on the host. Thread 0 of each block arrives with a
//    `red.release.gpu` after a __syncthreads and spins on `ld.acquire.gpu`
//    (CUTLASS's GenericBarrier pattern); between the two it runs the
//    caller's hook, which so costs nothing unless it outlasts the barrier.
//    A wait that outlasts kTimeoutNs traps (the launch fails with an error)
//    instead of hanging the card.
//  - Loads of data that blocks of the same launch wrote (activations,
//    partial sums, the caches, slot_pos) go through L2 (`ld.global.cg`),
//    never through the non-coherent or L1 path, which may hold a copy from
//    before the barrier.
//  - Weights reach shared memory by 1-D bulk copies (`cp.async.bulk`, no
//    tensor map) that complete on an mbarrier: a block's rows of one matrix
//    are contiguous in device memory, so one copy per matrix brings them.
//  - gemv: one warp per output row over the block's share of the rows, read
//    from shared memory, 16-byte weight slices per lane (lane, lane + 32,
//    ...; warp_sum at the end). The prologue (Pro) builds
//    the bf16 activation from a vector written during the launch; the
//    epilogue operands of the warp's rows (scale, bias, residual, gate) are
//    loaded before it, one row per lane, so one L2 round trip serves both.
//    Modes and the weight type are read at run time from a descriptor in
//    shared memory, so one copy of the code serves every GEMV of a frame
//    and stays in the instruction cache. Two earlier forms ran slower on an
//    H100 (PERF.md): weights loaded by each warp into registers, where each
//    phase waited on its own loads, and a GEMV inlined per call site, whose
//    code no longer fit the instruction cache.

#pragma once

#include "decode_common.cuh"

namespace ptt {
namespace pd {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned long long kEpoch = 1ull << 32;       // what one launch adds to the counter
constexpr unsigned long long kBlockQuota = 1ull << 20;  // what one block adds (>= its barriers)
constexpr unsigned long long kTimeoutNs = 10000000000ull;

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void red_release(unsigned long long* p, unsigned long long v) {
  asm volatile("red.release.gpu.global.add.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

struct GridBarrier {
  unsigned long long* ctr;
  unsigned long long base;  // this launch's start (thread 0)
  unsigned long long n;     // barriers this block passed

  __device__ void init(unsigned long long* c) {
    ctr = c;
    n = 0;
    base = 0;
    if (threadIdx.x == 0) base = ld_acquire(c) & ~(kEpoch - 1);
  }
  // Every block arrives, then waits for all: what a block wrote before is
  // visible to every block after (release/acquire at GPU scope). Thread 0
  // runs `hook` between its arrival and its wait, where it costs nothing
  // unless it outlasts the barrier.
  template <class Hook>
  __device__ void sync(Hook&& hook) {
    __syncthreads();
    ++n;
    if (threadIdx.x == 0) {
      red_release(ctr, 1);
      hook();
      const unsigned long long target = n * gridDim.x;
      unsigned long long t0 = 0;
      for (unsigned spins = 0; ld_acquire(ctr) - base < target; ++spins) {
        if ((spins & 1023u) == 0u) {
          const unsigned long long t = globaltimer();
          if (spins == 0u) t0 = t;
          else if (t - t0 > kTimeoutNs) __trap();
        }
      }
    }
    __syncthreads();
  }
  // After the last phase: top this launch's additions up to kEpoch.
  __device__ void finish() {
    if (threadIdx.x == 0) {
      unsigned long long add = kBlockQuota - n;
      if (blockIdx.x == 0) add += kEpoch - kBlockQuota * gridDim.x;
      red_release(ctr, add);
    }
  }
};

// Loads of data written during the launch, through L2.
__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ int ldcg(const int* p) { return __ldcg(p); }
__device__ __forceinline__ uint4 ldcg16(const void* p) { return __ldcg(reinterpret_cast<const uint4*>(p)); }

// ---------------------------------------------------------------- bulk copies
__device__ __forceinline__ uint32_t smem_addr(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// Order this thread's earlier shared-memory accesses (made visible to it by
// __syncthreads) before later copies of the async proxy into the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, counted on the mbarrier at `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// ---------------------------------------------------------------- prologues
// A prologue builds the GEMV's bf16 activation xs [K] from vectors written
// during the launch, the same in every block.
enum ProMode { P_CAST = 0, P_NORM = 1, P_SILU = 2, P_BF16 = 3, P_PARTS = 4 };

struct Pro {
  int mode;
  const float* x;                          // P_CAST, P_NORM, P_SILU: float32 [K]
  const bf16* xb;                          // P_BF16: [K]
  const float* w; const float* b;          // P_NORM: LayerNorm affine (null: none)
  float eps;
  const float* shift; const float* scale;  // P_NORM: AdaLN x * (1 + scale) + shift (null: none)
  const float* part; int chunks;           // P_PARTS: xs[h*64 + j] = sum_c part[(h*chunks + c)*64 + j]
  // Extras of a P_NORM prologue (all optional):
  const float* dot_w; const float* dot_b; float* dot_out;  // block 0: dot_out = <normalised x, dot_w> + dot_b
  int* store_at; int store_val;                            // block 0: *store_at = store_val
};

// The block's elements of a float vector written during the launch: thread
// t holds x[t + k * kThreads] in v[k] (0 past K), all loads in flight at once.
constexpr int kVecPer = 2;  // vectors of up to kVecPer * kThreads floats
__device__ __forceinline__ void load_vec(const float* x, int K, float (&v)[kVecPer]) {
#pragma unroll
  for (int k = 0; k < kVecPer; ++k) {
    const int i = threadIdx.x + k * kThreads;
    v[k] = i < K ? ldcg(x + i) : 0.f;
  }
}

constexpr int kMaxChunks = 8;  // attention partials a head (MAX_CHUNKS in ops/fused_segment.py)

// Block-wide sum (every thread gets it), inlined where it is used so that no
// call spills the caller's registers; `red` holds >= kWarps floats.
__device__ __forceinline__ float block_sum_i(float v, float* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) t += red[i];
  return t;
}
__device__ __forceinline__ float block_max_i(float v, float* red) {
  v = warp_max(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) t = fmaxf(t, red[i]);
  return t;
}

__device__ __forceinline__ void prologue(const Pro& p, int K, bf16* xs, float* red) {
  const int tid = threadIdx.x;
  switch (p.mode) {
    case P_CAST:
    case P_SILU: {
      float v[kVecPer];
      load_vec(p.x, K, v);
#pragma unroll
      for (int k = 0; k < kVecPer; ++k) {
        const int i = tid + k * kThreads;
        if (i < K) xs[i] = __float2bfloat16(p.mode == P_SILU ? silu(v[k]) : v[k]);
      }
      break;
    }
    case P_BF16:
      for (int i = tid * 8; i < K; i += kThreads * 8) *reinterpret_cast<uint4*>(xs + i) = ldcg16(p.xb + i);
      break;
    case P_PARTS: {  // each head's partial outputs summed in chunk order
      float v[kVecPer][kMaxChunks];
#pragma unroll
      for (int k = 0; k < kVecPer; ++k) {
        const int i = tid + k * kThreads, h = i / kHeadDim, j = i - h * kHeadDim;
#pragma unroll
        for (int c = 0; c < kMaxChunks; ++c)
          v[k][c] = i < K && c < p.chunks ? ldcg(p.part + (size_t)(h * p.chunks + c) * kHeadDim + j) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kVecPer; ++k) {
        const int i = tid + k * kThreads;
        float o = 0.f;
#pragma unroll
        for (int c = 0; c < kMaxChunks; ++c)
          if (c < p.chunks) o += v[k][c];
        if (i < K) xs[i] = __float2bfloat16(o);
      }
      break;
    }
    case P_NORM: {  // LayerNorm statistics in two passes, as ops/norms.layer_norm
      float v[kVecPer], sh[kVecPer], sc[kVecPer];
      load_vec(p.x, K, v);
      if (p.shift) {
        load_vec(p.shift, K, sh);
        load_vec(p.scale, K, sc);
      }
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kVecPer; ++k) s += v[k];
      const float mean = block_sum_i(s, red) / (float)K;
      float q = 0.f;
#pragma unroll
      for (int k = 0; k < kVecPer; ++k) {
        const float c = tid + k * kThreads < K ? v[k] - mean : 0.f;
        q += c * c;
      }
      const float rstd = rsqrtf(block_sum_i(q, red) / (float)K + p.eps);
      float dot = 0.f;
#pragma unroll
      for (int k = 0; k < kVecPer; ++k) {
        const int i = tid + k * kThreads;
        if (i >= K) continue;
        float y = (v[k] - mean) * rstd;
        if (p.w) y = y * p.w[i];
        if (p.b) y = y + p.b[i];
        if (p.shift) y = y * (1.f + sc[k]) + sh[k];
        xs[i] = __float2bfloat16(y);
        if (p.dot_w) dot += y * p.dot_w[i];
      }
      if (p.dot_w && blockIdx.x == 0) {
        dot = block_sum_i(dot, red);
        if (tid == 0) *p.dot_out = dot + p.dot_b[0];
      }
      break;
    }
  }
  if (p.store_at && blockIdx.x == 0 && tid == 0) __stcg(p.store_at, p.store_val);
}

// ---------------------------------------------------------------- epilogues
// v = acc [* scale[r]] [+ bias[r]] [+ bias2[r]], then by mode.
enum EpiMode { E_STORE = 0, E_ADD = 1, E_GELU_BF16 = 2, E_SILU = 3, E_FINAL = 4 };

struct Epi {
  int mode;
  float* out; bf16* outb;
  const float* scale; const float* bias; const float* bias2;
  const float* gate;  // E_ADD: out += gate * v (null: out += v)
  const float* base;  // E_FINAL: out = base + v
};

// The operands row r's epilogue reads, loaded early.
struct EpiRow {
  float scale, bias, bias2, base, gate;
};

__device__ __forceinline__ EpiRow epi_load(const Epi& e, int r) {
  EpiRow o;
  o.scale = e.scale ? __ldg(e.scale + r) : 1.f;
  o.bias = e.bias ? __ldg(e.bias + r) : 0.f;
  o.bias2 = e.bias2 ? __ldg(e.bias2 + r) : 0.f;
  o.base = e.mode == E_ADD ? ldcg(e.out + r) : e.mode == E_FINAL ? ldcg(e.base + r) : 0.f;
  o.gate = e.gate ? ldcg(e.gate + r) : 1.f;
  return o;
}

__device__ __forceinline__ void epi_store(const Epi& e, int r, float acc, const EpiRow& o) {
  float v = acc;
  if (e.scale) v = v * o.scale;
  if (e.bias) v = v + o.bias;
  if (e.bias2) v = v + o.bias2;
  switch (e.mode) {
    case E_STORE: __stcg(e.out + r, v); break;
    case E_ADD: __stcg(e.out + r, o.base + (e.gate ? o.gate * v : v)); break;
    case E_GELU_BF16: e.outb[r] = __float2bfloat16(gelu_erf(v)); break;
    case E_SILU: __stcg(e.out + r, silu(v)); break;
    case E_FINAL: __stcg(e.out + r, o.base + v); break;
  }
}

// ---------------------------------------------------------------- GEMV rows
template <typename WT>
struct Elems { static constexpr int value = 16; };
template <>
struct Elems<bf16> { static constexpr int value = 8; };

// One 16-byte weight slice (16 int8 codes or 8 bf16) times the bf16
// activation at x: decode_common.cuh's dot16.
__device__ __forceinline__ float dot_vec(const void* w, const bf16* x, const int8_t*) {
  return dot16(reinterpret_cast<const int8_t*>(w), x);
}
__device__ __forceinline__ float dot_vec(const void* w, const bf16* x, const bf16*) {
  return dot16(reinterpret_cast<const bf16*>(w), x);
}

// The warp's share of this block's rows [rb0, rb1).
__device__ __forceinline__ int2 warp_rows(int rb0, int rb1) {
  const int warp = threadIdx.x >> 5, n = rb1 - rb0;
  return make_int2(rb0 + warp * n / kWarps, rb0 + (warp + 1) * n / kWarps);
}

// Lane i holds the epilogue operands of the warp's row r0 + i (i < 32).
__device__ __forceinline__ EpiRow epi_prefetch(const Epi& e, int rb0, int rb1) {
  const int2 wr = warp_rows(rb0, rb1);
  const int r = wr.x + (threadIdx.x & 31);
  return r < wr.y ? epi_load(e, r) : EpiRow{1.f, 0.f, 0.f, 0.f, 1.f};
}

// One GEMV of a phase, described in shared memory by thread 0.
struct Gemv {
  Pro pro;
  Epi epi;
  const void* w;  // the matrix [N, K] in device memory
  int kind;    // its row table entry
  int K;       // inputs a row
  int bf16w;   // bf16 weights (else int8 codes)
  int woff;    // its rows' offset in the phase's ring bytes
  int second;  // its activation in the second buffer
};

template <typename WT>
__device__ __forceinline__ void rows_loop(const unsigned char* wsm, int K, int rb0, int2 wr, const bf16* xs,
                                          const Epi& epi, const EpiRow& eo) {
  constexpr int V = Elems<WT>::value, R = 4;
  const int lane = threadIdx.x & 31;
  const int nvec = K / V;
  const size_t row_bytes = (size_t)K * sizeof(WT);
  for (int r = wr.x; r < wr.y; r += R) {
    float acc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0.f;
    const unsigned char* w0 = wsm + (size_t)(r - rb0) * row_bytes;
    for (int v = lane; v < nvec; v += 32) {
#pragma unroll
      for (int i = 0; i < R; ++i)
        if (r + i < wr.y) acc[i] += dot_vec(w0 + i * row_bytes + v * 16, xs + v * V, (const WT*)nullptr);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = warp_sum(acc[i]);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int k = r + i - wr.x;  // the row's index in the warp's share
      if (r + i < wr.y) {
        if (k < 32) {
          if (lane == k) epi_store(epi, r + i, acc[i], eo);
        } else if (lane == 0) {
          epi_store(epi, r + i, acc[i], epi_load(epi, r + i));
        }
      }
    }
  }
}

// out[r] = epilogue(sum_k W[r, k] * xs[k]) for the rows [rb0, rb1) of the
// matrix W [N, K] that d describes and this block owns: the epilogue
// operands of the warp's rows, the prologue into xs, a __syncthreads, then
// the rows, whose bytes lie in shared memory at wsm (row rb0 first) once
// the mbarrier `bar` completes phase `parity`. Each warp takes an even
// share of the rows, up to four at a time; the lane that loaded a row's
// epilogue operands stores it. Modes and the weight type are read at run
// time, so one copy of this code serves every GEMV of a frame.
__device__ __forceinline__ void gemv(const Gemv& d, int rb0, int rb1, bf16* xs, const unsigned char* wsm,
                                     uint32_t bar, uint32_t parity, float* red) {
  const EpiRow eo = epi_prefetch(d.epi, rb0, rb1);
  prologue(d.pro, d.K, xs, red);
  __syncthreads();
  mbar_wait(bar, parity);
  const int2 wr = warp_rows(rb0, rb1);
  if (d.bf16w) rows_loop<bf16>(wsm, d.K, rb0, wr, xs, d.epi, eo);
  else rows_loop<int8_t>(wsm, d.K, rb0, wr, xs, d.epi, eo);
}

}  // namespace pd
}  // namespace ptt

// The FlowLM's int8 weight-only linears on Hopper tensor cores:
//
//   y[m, n] = out( s[n] * sum_k bf16(x[m, k]) * q[n, k] )
//
// x [M, K] float32 or bf16 (rounded to bf16 as it is read, to nearest even),
// q [N, K] int8 codes, s [N] float32 per-row scales (models/weights.py:
// quantize_int8); products on bf16 tensor cores (mma.sync m16n8k16) into a
// float32 accumulator, the scale applied to it in the epilogue, y written in
// x's type. With a null s the kernel writes the float32 accumulator unscaled
// (a row-parallel layer under tensor parallelism sums it over its ranks
// before the scale, ops/linear.py).
//
// It replaces no TPU kernel: the JAX package leaves this product to XLA's
// dot_general (pocket_tts_tpu/ops/linear.py). It was added because the
// port's plain form made a float32 copy of every code matrix, ran a float32
// GEMM on it and scaled in further kernels: five launches a linear and the
// weights' bytes read once and written four times over each frame.
//
// What bounds it on the H100:
//  - decode, M = B <= 64 rows: the int8 codes, read once (b6369a24: QKV
//    3.1 MB, 0.94 us at 3.35 TB/s; out_proj 1.0 MB, 0.31 us; linear1 and
//    linear2 4.2 MB, 1.25 us each; 75.5 MB, 22.5 us, for a frame's 25
//    linears); a launch costs ~1.2 us besides, and each block reads the
//    float32 activations of its K slice (x is re-read once per output tile).
//    The rows kernel: the output columns in 64- or 128-wide tiles, K in up to
//    8 slices of whole 128-wide units, one block each of a thread-block
//    cluster, at most one block per SM (ops/linear.py:launch_config). One
//    thread copies a block's whole slice of the codes and of x at once with
//    the Tensor Memory Accelerator (a few 2-D boxes onto one mbarrier, the
//    rows past M or N and the k past K zero-filled), so a call moves its
//    bytes in one round trip; the warps split the slice along k, so each
//    reads only its share of x from shared memory. The slices' float32
//    partial tiles meet in distributed shared memory and are summed in rank
//    order, so the result does not depend on timing and a graph replay
//    gives the eager call's bits.
//  - prefill, M = B * T up to ~10^4 rows: the tensor cores (M = 8192,
//    N = 4096, K = 1024: 68.7 GFLOP, 69 us at 989 TFLOP/s bf16 dense). The
//    tiles kernel: 128 x 256 (or 128 x 128) output tiles on 8 warps of 64 x
//    64 (64 x 32), K through a 2-stage ring of 128-wide units that one
//    thread fills with the Tensor Memory Accelerator. On an H100 it reaches
//    about a quarter of the peak (mma.sync, not wgmma; the float32
//    activations are read from shared memory by 4 warps each; PERF.md).
//
// The codes are widened to bf16 in registers (exact: |q| <= 127 needs 7
// bits): each byte is set into the mantissa of 2^23, the float has
// 2^23 + 128 taken off, and the high half of the float is the bf16. Within
// each 32-wide k block the kernel feeds the MMA's logical k slots from a
// permuted order, the same for x and the codes (a sum over k does not see
// the order): thread t of a quad takes the 8 consecutive k values 8t..8t+7,
// so a code fragment is one 8-byte shared load and an activation fragment
// one 16-byte (bf16) or two (float32) loads, laid out free of bank
// conflicts by the copies' 128-byte swizzle.
//
// Shapes: K % 16 == 0, N % 4 == 0, x and the codes 16-byte aligned (the
// wrapper pads others); any M. Rows past M or N and k past K are zero-filled
// by the copies and never stored.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;       // 8 warps a block
constexpr int kBK = 32;             // k values of one MMA block (two m16n8k16 steps)
constexpr int kMaxSplit = 8;        // K slices: the blocks of a cluster, the portable limit
constexpr int kMaxShared = 232448;  // H100: 227 KB per block, opt-in
constexpr int kUnit = 128;          // k values of a 128-byte code box: K slices and ring stages are whole units

struct Args {
  const void* x;
  const int8_t* q;
  const float* s;  // null: the float32 accumulator, unscaled
  void* y;
  int M, N, K, split, y_bf16;
};

// bf16x2 of two floats, lo in the low half, rounded to nearest even.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// Four int8 codes -> two bf16x2 (bytes 0-1, bytes 2-3), exactly.
__device__ __forceinline__ void widen_codes(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;  // code + 128, unsigned
  float f[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | j)) - 8388736.0f;  // (2^23 + u) - (2^23 + 128)
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// A barrier of every thread of the cluster; shared memory written before it
// is visible to the other blocks after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The float4 at p in the shared memory of block `rank` of this cluster.
__device__ __forceinline__ float4 cluster_load4(const float* p, int rank) {
  uint32_t addr = (uint32_t)__cvta_generic_to_shared(p), remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

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
// One 2-D box of a tensor map (coordinates: inner, outer) into this block's
// shared memory, counted on `bar`.
__device__ __forceinline__ void tma2d(uint32_t dst, const CUtensorMap* map, int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], "
      "[%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Every block of the cluster has written its partial tile `out` (BM x BN,
// row stride BN + 8, the same offset in each block): rank r sums its share
// of the tile's rows over the slices in rank order, scales and stores them.
template <int BM, int BN>
__device__ __forceinline__ void finish(const float* out, const Args& a, int rank, int m0, int n0) {
  if (a.split > 1)
    cluster_sync();
  else
    __syncthreads();
  const int rows = (BM + a.split - 1) / a.split, r0 = rank * rows, r1 = min(BM, r0 + rows);
  constexpr int C4 = BN / 4;
  for (int i = threadIdx.x; i < (r1 - r0) * C4; i += kThreads) {
    const int r = r0 + i / C4, c = (i % C4) * 4, m = m0 + r, n = n0 + c;
    if (m >= a.M || n >= a.N) continue;
    const float* p = out + r * (BN + 8) + c;
    float4 v;
    if (a.split > 1) {
      float4 u[kMaxSplit];  // every slice's loads in flight together, then summed in rank order
#pragma unroll
      for (int q = 0; q < kMaxSplit; ++q)
        if (q < a.split) u[q] = cluster_load4(p, q);
      v = u[0];
#pragma unroll
      for (int q = 1; q < kMaxSplit; ++q)
        if (q < a.split) {
          v.x += u[q].x;
          v.y += u[q].y;
          v.z += u[q].z;
          v.w += u[q].w;
        }
    } else {
      v = *reinterpret_cast<const float4*>(p);
    }
    if (a.s) {
      v.x *= __ldg(a.s + n);
      v.y *= __ldg(a.s + n + 1);
      v.z *= __ldg(a.s + n + 2);
      v.w *= __ldg(a.s + n + 3);
    }
    const size_t o = (size_t)m * a.N + n;
    if (a.y_bf16) {
      uint2 w;
      w.x = pack_bf16(v.x, v.y);
      w.y = pack_bf16(v.z, v.w);
      *reinterpret_cast<uint2*>(reinterpret_cast<bf16*>(a.y) + o) = w;
    } else {
      *reinterpret_cast<float4*>(reinterpret_cast<float*>(a.y) + o) = v;
    }
  }
  if (a.split > 1) cluster_sync();  // no block leaves while another still reads its tile
}

// The rows kernel copies x and the codes in boxes 128 bytes wide (x: 64
// rows of 32 float32 or 64 bf16 values; codes: BN rows of 128 values) with
// the Tensor Memory Accelerator's 128-byte swizzle: in each box the 16-byte
// chunk j of row r lies at chunk j ^ (r % 8). A fragment load reads 8
// consecutive k of 8 rows (x) or 4 rows (codes) at once; the rows that share
// a load must land on other chunks, so the MMA's row g reads box row xrow(g)
// (float32: g; bf16: rows 4 apart share a load) and its column g code row
// wrow(g) (rows 2 apart), and the accumulators are stored back to the rows
// and columns they came from.
template <typename XT>
__device__ __forceinline__ int xrow(int g) {
  return sizeof(XT) == 4 ? g : ((g & 1) << 2) | (g >> 1);
}
__device__ __forceinline__ int wrow(int g) { return ((g & 3) << 1) | (g >> 2); }

struct Maps {
  CUtensorMap x, w;  // x [M, K] in boxes of 64 rows x 128 bytes; codes [N, K] in boxes of BN rows x 128
};

// Dynamic shared memory of a rows-kernel block whose slice holds `units`
// units (ops/linear.py:rows_shared_bytes): the mbarrier, slack to align the
// boxes to 1024 bytes, then the x boxes (64 x 128 x xbytes bytes a unit)
// and the code boxes (BN x 128 a unit), or the WK warps' partial tiles.
__host__ __device__ inline int rows_smem(int units, int xbytes, int BN, int WK) {
  const int slices = units * (64 * kUnit * xbytes + BN * kUnit), tiles = WK * 64 * (BN + 8) * 4;
  return 16 + 1024 + (slices > tiles ? slices : tiles);
}

// The MMAs of one 32-wide k block from the swizzled boxes: x box `xb` (its
// 64-byte half `half` for bf16), code box `wb` at 32-byte column `kq`.
template <typename XT, int MT, int NT>
__device__ __forceinline__ void mma_boxes(float (&acc)[MT][NT][4], const unsigned char* xb, int half,
                                          const unsigned char* wb, int kq, int g, int t) {
  uint32_t af[MT][2][4];
  uint2 codes[NT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mt * 16 + h * 8 + xrow<XT>(g);
      const unsigned char* row = xb + r * 128;
      if constexpr (sizeof(XT) == 4) {
        const float4 p = *reinterpret_cast<const float4*>(row + (((2 * t) ^ (r & 7)) << 4));
        const float4 q = *reinterpret_cast<const float4*>(row + (((2 * t + 1) ^ (r & 7)) << 4));
        af[mt][h][0] = pack_bf16(p.x, p.y);
        af[mt][h][1] = pack_bf16(p.z, p.w);
        af[mt][h][2] = pack_bf16(q.x, q.y);
        af[mt][h][3] = pack_bf16(q.z, q.w);
      } else {
        const uint4 p = *reinterpret_cast<const uint4*>(row + (((4 * half + t) ^ (r & 7)) << 4));
        af[mt][h][0] = p.x;
        af[mt][h][1] = p.y;
        af[mt][h][2] = p.z;
        af[mt][h][3] = p.w;
      }
    }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int r = nt * 8 + wrow(g);
    codes[nt] = *reinterpret_cast<const uint2*>(wb + r * 128 + (((2 * kq + (t >> 1)) ^ (r & 7)) << 4) + 8 * (t & 1));
  }
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t b0, b1;
      widen_codes(s ? codes[nt].y : codes[nt].x, b0, b1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        mma(acc[mt][nt], af[mt][0][2 * s], af[mt][1][2 * s], af[mt][0][2 * s + 1], af[mt][1][2 * s + 1], b0, b1);
    }
}

// The warp's accumulators, fed from box rows xrow(g) and code rows wrow(g),
// into a BM x BN float32 tile (row stride BN + 8) at the rows and columns
// they belong to.
template <typename XT, int MT, int NT, int BN>
__device__ __forceinline__ void write_box_tile(float* out, const float (&acc)[MT][NT][4], int r0, int c0, int g,
                                               int t) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[(r0 + mt * 16 + xrow<XT>(g) + (e >> 1) * 8) * (BN + 8) + c0 + nt * 8 + wrow(2 * t + (e & 1))] =
            acc[mt][nt][e];
}

// Decode (M <= 64 rows: a step of B streams). Grid (split, N tiles); the
// slices are whole 128-wide units of K. One thread copies a block's whole
// slice of the codes and of x into shared memory at once, a few boxes onto
// one mbarrier, so a call moves its bytes in one round trip; then the 8
// warps, WK along k by WN along n, each take every WK-th 32-wide k block of
// the slice for 64 rows by BN / WN columns (a warp reads 1 / WK of x); the
// WK partial tiles are summed in order, then the cluster's slices in rank
// order. Rows past M or N and k past K are zeros from the copies.
template <typename XT, int WK, int WN, int NT>
__global__ void __launch_bounds__(kThreads) int8_linear_rows_kernel(const Args a, const __grid_constant__ Maps maps) {
  constexpr int MT = 4, BM = 64, BN = WN * NT * 8, XBOX = kUnit / (int)sizeof(XT);  // k values an x box holds
  static_assert(WK * WN * 32 == kThreads, "8 warps");
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wk = warp / WN, wn = warp % WN;
  const int rank = blockIdx.x, n0 = blockIdx.y * BN;
  const int units = (a.K + kUnit - 1) / kUnit, ucap = (units + a.split - 1) / a.split;
  const int u0 = rank * units / a.split, u1 = (rank + 1) * units / a.split;
  const int k0 = u0 * kUnit, klen = min(a.K, u1 * kUnit) - k0;
  const int nblk = (klen + kBK - 1) / kBK, xboxes = (klen + XBOX - 1) / XBOX;
  const uint32_t bar = (uint32_t)__cvta_generic_to_shared(smem), base = (bar + 16 + 1023) & ~1023u;
  unsigned char* data = smem + (base - bar);
  const int wregion = ucap * BM * kUnit * (int)sizeof(XT);  // the code boxes follow the x boxes
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(bar, (uint32_t)((u1 - u0) * BN * kUnit + xboxes * BM * 128));
    for (int u = 0; u < u1 - u0; ++u) tma2d(base + wregion + u * BN * kUnit, &maps.w, k0 + u * kUnit, n0, bar);
    for (int b = 0; b < xboxes; ++b) tma2d(base + b * BM * 128, &maps.x, k0 + b * XBOX, 0, bar);
  }
  __syncthreads();  // the barrier is initialised before anyone waits on it
  mbar_wait(bar, 0);

  float acc[MT][NT][4] = {};
  for (int blk = wk; blk < nblk; blk += WK) {
    const int xbox = sizeof(XT) == 4 ? blk : blk >> 1;
    mma_boxes<XT, MT, NT>(acc, data + xbox * BM * 128, blk & 1,
                          data + wregion + (blk >> 2) * BN * kUnit + wn * NT * 8 * 128, blk & 3, g, t);
  }
  __syncthreads();  // the boxes' bytes become the partial tiles
  float* out = reinterpret_cast<float*>(data);
  constexpr int kTile = BM * (BN + 8);
  write_box_tile<XT, MT, NT, BN>(out + wk * kTile, acc, 0, wn * NT * 8, g, t);
  if (WK > 1) {
    __syncthreads();
    for (int i = tid; i < BM * BN / 4; i += kThreads) {
      float* p = out + (i / (BN / 4)) * (BN + 8) + (i % (BN / 4)) * 4;
      float4 v = *reinterpret_cast<const float4*>(p);
#pragma unroll
      for (int w = 1; w < WK; ++w) {
        const float4 u = *reinterpret_cast<const float4*>(p + w * kTile);
        v.x += u.x;
        v.y += u.y;
        v.z += u.z;
        v.w += u.w;
      }
      *reinterpret_cast<float4*>(p) = v;
    }
  }
  finish<BM, BN>(out, a, rank, 0, n0);
}

// Ring stages of the tiles kernel, one 128-wide unit of K each.
constexpr int kTileStages = 2;

// Dynamic shared memory of a tiles-kernel block (ops/linear.py): barriers,
// alignment slack, then kTileStages units of x boxes (BM rows) and code
// boxes (BN rows), or the output tile.
__host__ __device__ inline int tiles_smem(int xbytes, int BM, int BN) {
  const int ring = kTileStages * (BM * kUnit * xbytes + BN * kUnit), tile = BM * (BN + 8) * 4;
  return 64 + 1024 + (ring > tile ? ring : tile);
}

// Prefill (M > 64 rows). Grid (split, N tiles, M tiles); a block computes a
// BM x BN output tile over its K slice (whole units), one unit a stage of a
// kTileStages-slot ring that one thread fills with Tensor Memory
// Accelerator boxes (x: BM rows x 128 bytes, XB boxes a unit; codes: BN
// rows x 128) while the 8 warps, WM x WN of MT x NT MMA tiles, multiply the
// unit before it.
template <typename XT, int WM, int WN, int MT, int NT>
__global__ void __launch_bounds__(kThreads) int8_linear_tiles_kernel(const Args a, const __grid_constant__ Maps maps) {
  constexpr int BM = WM * MT * 16, BN = WN * NT * 8, XBOX = kUnit / (int)sizeof(XT);
  constexpr int kX = BM * kUnit * (int)sizeof(XT), kStage = kX + BN * kUnit;  // bytes of a stage's x and codes
  static_assert(WM * WN * 32 == kThreads, "8 warps");
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int rank = blockIdx.x, n0 = blockIdx.y * BN, m0 = blockIdx.z * BM;
  const int units = (a.K + kUnit - 1) / kUnit;
  const int u0 = rank * units / a.split, u1 = (rank + 1) * units / a.split;
  const uint32_t bars = (uint32_t)__cvta_generic_to_shared(smem), base = (bars + 64 + 1023) & ~1023u;
  unsigned char* data = smem + (base - bars);
  auto load = [&](int u) {  // unit u into its slot (one thread)
    const uint32_t bar = bars + (u - u0) % kTileStages * 8, dst = base + (u - u0) % kTileStages * kStage;
    const int k = u * kUnit, xboxes = (min(kUnit, a.K - k) + XBOX - 1) / XBOX;
    mbar_expect(bar, (uint32_t)(BN * kUnit + xboxes * BM * 128));
    tma2d(dst + kX, &maps.w, k, n0, bar);
    for (int b = 0; b < xboxes; ++b) tma2d(dst + b * BM * 128, &maps.x, k + b * XBOX, m0, bar);
  };
  if (tid == 0) {
    for (int i = 0; i < kTileStages; ++i) mbar_init(bars + i * 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int u = u0; u < u1 && u < u0 + kTileStages; ++u) load(u);
  }
  __syncthreads();

  float acc[MT][NT][4] = {};
  for (int u = u0; u < u1; ++u) {
    const int i = u - u0, slot = i % kTileStages;
    mbar_wait(bars + slot * 8, (uint32_t)((i / kTileStages) & 1));
    const unsigned char* stage = data + slot * kStage;
    const int nblk = (min(kUnit, a.K - u * kUnit) + kBK - 1) / kBK;
    for (int blk = 0; blk < nblk; ++blk)
      mma_boxes<XT, MT, NT>(acc, stage + (sizeof(XT) == 4 ? blk : blk >> 1) * BM * 128 + wm * MT * 16 * 128,
                            blk & 1, stage + kX + wn * NT * 8 * 128, blk, g, t);
    __syncthreads();  // every warp is done with the slot
    if (tid == 0 && u + kTileStages < u1) load(u + kTileStages);
  }
  float* out = reinterpret_cast<float*>(data);
  write_box_tile<XT, MT, NT, BN>(out, acc, wm * MT * 16, wn * NT * 8, g, t);
  finish<BM, BN>(out, a, rank, m0, n0);
}

// cuTensorMapEncodeTiled, reached through the runtime (no link to libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D map of a row-major [rows, cols] matrix in boxes of box_rows x
// 128 bytes, 128-byte swizzle, zeros outside.
bool encode_map(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* p, int rows, int cols,
                int box_rows) {
  EncodeTiled encode = encoder();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows}, strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / elem), (cuuint32_t)box_rows}, unit[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(p), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launch Kernel(params...) on `grid` with `smem` bytes of dynamic shared
// memory (its attributes set once per device, for `most`), as clusters of
// `split` blocks along x where split > 1.
template <auto Kernel, typename... P>
cudaError_t start(int most, int smem, dim3 grid, int split, cudaStream_t st, const P&... params) {
  static unsigned configured = 0u;  // one bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 32 && !(configured & (1u << dev))) {
    e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(Kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    configured |= 1u << dev;
  }
  if (split == 1) {
    Kernel<<<grid, kThreads, smem, st>>>(params...);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  void* args[] = {const_cast<P*>(&params)...};
  e = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(Kernel), args);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename XT, int WK, int WN, int NT>
cudaError_t launch_rows(const Args& a, cudaStream_t st) {
  constexpr int BN = WN * NT * 8, XB = (int)sizeof(XT);
  const int units = (a.K + kUnit - 1) / kUnit, smem = rows_smem((units + a.split - 1) / a.split, XB, BN, WK);
  if (smem > kMaxShared || a.M > 64) return cudaErrorInvalidValue;
  Maps maps;
  if (!encode_map(&maps.x, XB == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, XB, a.x, a.M,
                  a.K, 64) ||
      !encode_map(&maps.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.q, a.N, a.K, BN))
    return cudaErrorInvalidValue;
  return start<int8_linear_rows_kernel<XT, WK, WN, NT>>(kMaxShared, smem, dim3(a.split, (a.N + BN - 1) / BN, 1),
                                                       a.split, st, a, maps);
}

template <typename XT, int WM, int WN, int MT, int NT>
cudaError_t launch_tiles(const Args& a, cudaStream_t st) {
  constexpr int BM = WM * MT * 16, BN = WN * NT * 8, XB = (int)sizeof(XT);
  const int smem = tiles_smem(XB, BM, BN);
  if (smem > kMaxShared) return cudaErrorInvalidValue;
  Maps maps;
  if (!encode_map(&maps.x, XB == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, XB, a.x, a.M,
                  a.K, BM) ||
      !encode_map(&maps.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.q, a.N, a.K, BN))
    return cudaErrorInvalidValue;
  return start<int8_linear_tiles_kernel<XT, WM, WN, MT, NT>>(
      smem, smem, dim3(a.split, (a.N + BN - 1) / BN, (a.M + BM - 1) / BM), a.split, st, a, maps);
}

// Tiles (ops/linear.py:TILES), 8 warps each. Rows kernel (M <= 64): 0: 64 x
// 64 (4 along k x 2 of 64 x 32), 1: 64 x 128 (2 along k x 4 of 64 x 32).
// Tiles kernel: 2: 128 x 128 (2 x 4 of 64 x 32), 3: 128 x 256 (2 x 4 of 64 x
// 64).
template <typename XT>
cudaError_t launch_tile(int tile, const Args& a, cudaStream_t st) {
  switch (tile) {
    case 0: return launch_rows<XT, 4, 2, 4>(a, st);
    case 1: return launch_rows<XT, 2, 4, 4>(a, st);
    case 2: return launch_tiles<XT, 2, 4, 4, 4>(a, st);
    case 3: return launch_tiles<XT, 2, 4, 4, 8>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x [M, K] (x_kind 0 float32, 1 bf16), q [N, K] int8, s [N] float32 or null,
// y [M, N] (y_bf16: bf16, else float32; float32 where s is null), all
// contiguous, x and q 16-byte aligned; K % 16 == 0, N % 4 == 0;
// 1 <= split <= min(8, ceil(K / 128)).
extern "C" int ptt_int8_linear(const void* x, int x_kind, const int8_t* q, const float* s, void* y, int y_bf16,
                               int M, int N, int K, int tile, int split, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 || N % 4 || split < 1 || split > kMaxSplit ||
      split > (K + kUnit - 1) / kUnit || (!s && y_bf16) ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(q)) % 16)
    return (int)cudaErrorInvalidValue;
  const Args a{x, q, s, y, M, N, K, split, y_bf16};
  cudaStream_t st = (cudaStream_t)stream;
  switch (x_kind) {
    case 0: return (int)launch_tile<float>(tile, a, st);
    case 1: return (int)launch_tile<bf16>(tile, a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Hopper port of the JAX package's batch_decode_attention
// (pocket_tts_tpu/ops/batch_attention.py:batch_decode_attention, Pallas
// kernel `_kernel`): one query per stream (T == 1) over the slot-major KV
// cache [B, C, H, d], B > 1, reading rows [0, R) only, any R in (0, C]. A
// row is valid for stream b when 0 <= slot_pos[b, r] <= qpos[b]; a stream
// with no valid row outputs 0. int8 caches carry one float32 scale per row,
// shared by all H heads: the K scale multiplies the scores, the V scale the
// softmax weights.
//
// Bound on the H100: the K and V rows, read once. bf16 at B=64, R=512,
// H*d=1024 is 2*B*R*H*d*2 = 134 MB, 40.3 us at 3.35 TB/s; int8 is 67 MB plus
// 0.26 MB of scales, 20.3 us. The batch decode makes one call per layer and
// step (6 per frame at b6369a24). About one operation per byte: the tensor
// cores do not apply; the bytes in flight and the launches set the pace.
//
// Design: one launch per call. A (stream b, head h) work item's rows
// (row slices of d = 64 values at a row stride of H*d) belong to one block,
// or are cut into `split` chunks of `chunk` rows, one per block of a
// thread-block cluster, where one block's shared memory cannot hold the
// scores of all R rows or where the call has too few items to fill the SMs
// (ops/batch_attention.py:launch_config).
//   0. Each block reads its rows' slot_pos once into validity bits in shared
//      memory; a block alone whose stream has no valid row writes 0 and
//      reads nothing more.
//   1. A ring of `stages` row tiles in shared memory is fed by the Tensor
//      Memory Accelerator: one thread issues a 3-D box of rows x 64 values
//      of head h (plus their int8 row scales) for each box of the tile that
//      holds a valid row (16-row boxes for bf16 at 128 threads, else one
//      box per tile: Geo), and the tile's mbarrier counts the bytes in. The
//      maps' row extent is R, so rows at or past R lie outside them:
//      zero-filled, never read. A hole inside a fetched box is read but
//      selected away (never multiplied by a zero weight, so even a NaN in it
//      adds exactly 0); a stage's rows that were not fetched keep what they
//      held and are selected away too.
//   2. Phase K: q (rounded to bf16 for bf16 and int8 caches) . k in float32
//      per row, times the K scale and 1/sqrt(d), into a shared float score
//      array (-inf for an invalid row), with a running max.
//   3. The ring runs on from the last K tile into the V tiles, so the first
//      V tiles land while the block reduces the exact max and denominator
//      over its scores and normalises them in place: the weights are rounded
//      after normalising, as the plain version rounds them. The blocks of a
//      cluster exchange their maxima, then their denominators (taken against
//      the common max), through distributed shared memory, so every block
//      normalises with the same max and denominator; a cluster whose stream
//      has no valid row writes 0.
//   4. Phase V: w = bf16(e / l * v_scale) per row, w * v summed in float32,
//      then across the block's warps (and, in a cluster, by its first block
//      across the blocks, in rank order); the [64] output is written in q's
//      type.
// Against the earlier three-launch split-R design this removes two launches
// and the gaps between them, the float32 scores / statistics / partial
// outputs round trip through device memory and the wrapper's four
// allocations, and keeps `stages - 1` tiles of copies in flight behind each
// block's arithmetic. Per-thread 16-byte cp.async copies (which could skip
// each invalid row) reached only 76% (bf16) and 58% (int8) of the bound at
// B=64, R=512 on an H100 80GB HBM3 at 700 W, with more stages not helping;
// one bulk copy per row was bound by the TMA unit's issue rate. Boxes of a
// whole tile skipped only tiles without a valid row, and read the text
// padding and unwritten rows that the batch path's bf16 caches hold; 16-row
// boxes skip most of them there, but made int8 and small-grid calls slower.
// With few blocks per SM the arithmetic of a few warps, not the copies, sets
// the pace, so the wrapper gives such calls wider blocks (up to 512 threads,
// 1024 was no faster) and taller tiles; one block alone on an SM streams
// only ~20 GB/s, so a call of far fewer (stream, head) items than SMs is cut
// into clusters.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kD = 64;              // head dim
constexpr int kBarBytes = 16 * 8;   // one mbarrier per ring stage, up to 16
constexpr int kMaxShared = 232448;  // H100: 227 KB per block, opt-in
constexpr int kMaxSplit = 8;        // blocks of a cluster, the portable limit

// 16 bytes of cache elements -> float.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  static constexpr bool kScaled = false;
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
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
  static constexpr bool kScaled = false;
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
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
  static constexpr bool kScaled = true;
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_UINT8;  // the bits are copied as they are
  __device__ static void unpack(const uint4& u, float* o) {
    const int8_t* f = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = (float)f[i];
  }
  // int8 rows are computed as bf16, like _sdpa_slots.
  __device__ static float round(float x) { return __bfloat162float(__float2bfloat16(x)); }
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// The one arrival of a stage's use, announcing the bytes its copies bring.
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
__device__ __forceinline__ void tma3d(uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], "
      "[%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma2d(uint32_t dst, const CUtensorMap* map, int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], "
      "[%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// A barrier of every thread of the cluster; shared memory written before it
// is visible to the other blocks after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The float at p in the shared memory of block `rank` of this cluster.
__device__ __forceinline__ float cluster_load(const float* p, int rank) {
  uint32_t addr = (uint32_t)__cvta_generic_to_shared(p), remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// K and V as [B, R, H*d] (rows at or past R outside), the int8 scales as
// [B, R].
struct Maps {
  CUtensorMap k, v, ks, vs;
};

struct Args {
  const void* q;  // [B, H, 1, d] float32 or bf16, strides q_sb, q_sh (d contiguous)
  int q_sb, q_sh;
  const int* slot_pos;  // rows of stride sp_stride
  int sp_stride;
  const int* qpos;  // [B]
  int H, R, stages;
  int split, chunk;  // a work item's blocks (one cluster) and the rows of each
  void* out;         // [B, H, d] in q's type
};

// Shared memory of one block: the stages' mbarriers, the ring, a
// [warps][64] float32 reduction buffer, the cluster's exchange (max,
// denominator, [64] partial output), Rp float32 scores, Rp validity bits.
// A tile is fetched as TR / BOX boxes: 16 rows for bf16 at 128 threads,
// whose batch-path caches hold short runs of invalid rows that a box
// without a valid row skips; one box per tile otherwise, where a thread
// issuing many small boxes would set the pace (int8 rows are half as wide,
// and a wide block's tile is 256 rows).
template <typename T, int THREADS, int TR>
struct Geo {
  static constexpr int N = Vec<T>::N, LPR = kD / N, RPP = THREADS / LPR, PASSES = TR / RPP;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int BOX = sizeof(T) == 2 && THREADS == 128 ? 16 : TR;
  static constexpr int TILE = TR * kD * (int)sizeof(T);
  // int8: each box's row scales at a 128-byte multiple (a TMA destination
  // is 128-byte aligned); scale(row) finds them.
  static constexpr int SCALE_STRIDE = (BOX * 4 + 127) / 128 * 128;
  static constexpr int SLOT = TILE + (Vec<T>::kScaled ? TR / BOX * SCALE_STRIDE : 0);
  static constexpr int ALIGN = TR > 64 ? TR : 64;  // Rp, a multiple of the tile
  static_assert(PASSES * RPP == TR && TR % 32 == 0 && TR <= 256 && TR % BOX == 0 && SLOT % 128 == 0, "tiles");
  __device__ static int scale(int row) { return row / BOX * (SCALE_STRIDE / 4) + row % BOX; }
};

template <typename T, typename Q, int THREADS, int TR>
__global__ void __launch_bounds__(THREADS, 1024 / THREADS)
    decode_attention_kernel(const __grid_constant__ Maps maps, const Args a) {
  using G = Geo<T, THREADS, TR>;
  constexpr int N = G::N, LPR = G::LPR, RPP = G::RPP, kWarps = G::WARPS;
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = a.H, R = a.R, S = a.stages, split = a.split;
  const int item = blockIdx.x / split, rank = blockIdx.x % split;  // rank: the block's rank in its cluster
  const int h = item % H, b = item / H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = tid % LPR, rsub = tid / LPR;
  const int row0 = rank * a.chunk, rows = min(R - row0, a.chunk);  // the block's rows [row0, row0 + rows)
  const int Rp = (rows + G::ALIGN - 1) / G::ALIGN * G::ALIGN;
  const int nk = Rp / TR;  // tiles per phase
  const uint32_t bars = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t ring = bars + kBarBytes;
  unsigned char* ring_p = smem + kBarBytes;
  float* red = reinterpret_cast<float*>(ring_p + S * G::SLOT);
  // The cluster's exchange (max, denominator, [64] partial output) sits at
  // the same offset in every block of the cluster: before the scores,
  // whose length differs in a last block of fewer rows.
  float* xch = red + kWarps * kD;
  float* sc = xch + 2 + kD;
  uint32_t* mask = reinterpret_cast<uint32_t*>(sc + Rp);
  Q* out = static_cast<Q*>(a.out) + (size_t)item * kD;

  const int qp = a.qpos[b];
  float qf[N];
  {
    const Q* qb = static_cast<const Q*>(a.q) + (size_t)b * a.q_sb + (size_t)h * a.q_sh + sub * N;
#pragma unroll
    for (int j = 0; j < N; ++j) qf[j] = Vec<T>::round(to_float(qb[j]));
  }
  if (tid < S) mbar_init(bars + tid * 8, 1);

  // 0. Validity bits of the block's rows; rows past them are invalid. Local
  // row r is row row0 + r of the cache.
  const int* spb = a.slot_pos + (size_t)b * a.sp_stride + row0;
  int any = 0;
#pragma unroll 4
  for (int w = warp; w < Rp / 32; w += kWarps) {
    const int r = w * 32 + lane;
    bool ok = false;
    if (r < rows) {
      const int p = __ldg(spb + r);
      ok = p >= 0 && p <= qp;
    }
    const uint32_t bits = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) mask[w] = bits;
    any |= bits != 0u;
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  if (!__syncthreads_or(any) && split == 1) {  // no valid row: the output is 0
    if (tid < kD) store(out + tid, 0.f);
    return;
  }
  auto valid = [&](int r) { return ((mask[r >> 5] >> (r & 31)) & 1u) != 0u; };

  // Tile j < nk is K rows [j*TR, (j+1)*TR); tile nk + j the same V rows.
  // Thread 0 fetches it into stage j % S, whose mbarrier completes its
  // (j / S)-th phase when the bytes are in.
  // Each box of the tile that holds a valid row is fetched, with its int8
  // row scales; a box without one is not.
  auto issue = [&](int j) {
    if (tid != 0) return;
    constexpr int BOX = G::BOX;
    const bool is_v = j >= nk;
    const int r0 = (is_v ? j - nk : j) * TR;
    const uint32_t bar = bars + (j % S) * 8, dst = ring + (j % S) * G::SLOT;
    constexpr uint32_t kBoxBytes = BOX * kD * sizeof(T) + (Vec<T>::kScaled ? BOX * 4 : 0);
    uint32_t boxes = 0u;  // bit g: box g holds a valid row
#pragma unroll
    for (int g = 0; g < TR / BOX; ++g) {
      uint32_t bits = 0u;
#pragma unroll
      for (int w = 0; w < (BOX + 31) / 32; ++w) bits |= mask[((r0 + g * BOX) >> 5) + w];
      if (BOX < 32) bits = bits >> ((r0 + g * BOX) & 31) & ((1u << (BOX % 32)) - 1u);
      boxes |= (bits ? 1u : 0u) << g;
    }
    mbar_expect(bar, __popc(boxes) * kBoxBytes);
#pragma unroll
    for (int g = 0; g < TR / BOX; ++g) {
      if (!(boxes >> g & 1u)) continue;
      const int row = row0 + r0 + g * BOX;
      tma3d(dst + g * BOX * kD * sizeof(T), is_v ? &maps.v : &maps.k, h * kD, row, b, bar);
      if (Vec<T>::kScaled) tma2d(dst + G::TILE + g * G::SCALE_STRIDE, is_v ? &maps.vs : &maps.ks, row, b, bar);
    }
  };
  // Tile i has landed; tile i + S - 1 goes into the stage that tile i - 1
  // left, which every thread has finished reading.
  auto advance = [&](int i) {
    mbar_wait(bars + (i % S) * 8, (uint32_t)((i / S) & 1));
    __syncthreads();
    if (i + S - 1 < 2 * nk) issue(i + S - 1);
    return ring_p + (i % S) * G::SLOT;
  };
  for (int j = 0; j < S - 1 && j < 2 * nk; ++j) issue(j);

  // 2. Phase K.
  float mx = -INFINITY;
  for (int i = 0; i < nk; ++i) {
    const unsigned char* tile = advance(i);
    const float* scale = reinterpret_cast<const float*>(tile + G::TILE);
#pragma unroll
    for (int p = 0; p < G::PASSES; ++p) {
      float kv[N];
      Vec<T>::unpack(reinterpret_cast<const uint4*>(tile)[p * THREADS + tid], kv);
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) dot = fmaf(kv[j], qf[j], dot);
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (sub == 0) {
        const int row = p * RPP + rsub, r = i * TR + row;
        float s = -INFINITY;
        if (valid(r)) s = Vec<T>::kScaled ? dot * (scale[G::scale(row)] * 0.125f) : dot * 0.125f;  // 1 / sqrt(64)
        sc[r] = s;
        mx = fmaxf(mx, s);
      }
    }
  }

  // 3. The exact softmax over the R scores, while the first V tiles land.
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (lane == 0) red[warp] = mx;
  __syncthreads();  // also publishes the last K tile's scores
  float m = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
  if (split > 1) {
    if (tid == 0) xch[0] = m;
    cluster_sync();
    for (int c = 0; c < split; ++c) m = fmaxf(m, cluster_load(xch, c));
    if (m == -INFINITY) {  // no valid row in the stream: the output is 0
      cluster_sync();      // every block has read the others' maxima
      if (rank == 0 && tid < kD) store(out + tid, 0.f);
      return;
    }
  }
  float l = 0.f;
  for (int r = tid; r < Rp; r += THREADS) {
    const float e = expf(sc[r] - m);  // an invalid row: exp(-inf) = 0
    sc[r] = e;
    l += e;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
  __syncthreads();  // every thread has read the max from red
  if (lane == 0) red[warp] = l;
  __syncthreads();
  l = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) l += red[w];
  if (split > 1) {  // the cluster's denominator, summed in rank order by every block
    if (tid == 0) xch[1] = l;
    cluster_sync();
    l = 0.f;
    for (int c = 0; c < split; ++c) l += cluster_load(xch + 1, c);
  }
  for (int r = tid; r < Rp; r += THREADS) sc[r] = __fdiv_rn(sc[r], l);
  __syncthreads();

  // 4. Phase V. An invalid row adds nothing, whatever its stage holds.
  float acc[N];
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n] = 0.f;
  for (int i = nk; i < 2 * nk; ++i) {
    const unsigned char* tile = advance(i);
    const float* scale = reinterpret_cast<const float*>(tile + G::TILE);
#pragma unroll
    for (int p = 0; p < G::PASSES; ++p) {
      const int row = p * RPP + rsub, r = (i - nk) * TR + row;
      const bool ok = valid(r);
      float w = sc[r];
      if (Vec<T>::kScaled) w *= ok ? scale[G::scale(row)] : 0.f;
      w = Vec<T>::round(w);
      float vv[N];
      Vec<T>::unpack(reinterpret_cast<const uint4*>(tile)[p * THREADS + tid], vv);
#pragma unroll
      for (int n = 0; n < N; ++n) acc[n] = fmaf(w, ok ? vv[n] : 0.f, acc[n]);
    }
  }
  // Sum over the rows: the lanes of a warp that share `sub`, then the warps.
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1)
#pragma unroll
    for (int n = 0; n < N; ++n) acc[n] += __shfl_xor_sync(0xffffffffu, acc[n], o);
  if (lane < LPR)
#pragma unroll
    for (int n = 0; n < N; ++n) red[warp * kD + sub * N + n] = acc[n];
  __syncthreads();
  if (tid < kD) {
    float t = red[tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) t += red[w * kD + tid];
    if (split == 1)
      store(out + tid, t);
    else
      xch[2 + tid] = t;
  }
  if (split > 1) {  // the first block sums the cluster's partial outputs in rank order
    cluster_sync();
    if (rank == 0 && tid < kD) {
      float t = 0.f;
      for (int c = 0; c < split; ++c) t += cluster_load(xch + 2 + tid, c);
      store(out + tid, t);
    }
    cluster_sync();  // no block leaves while the first still reads its shared memory
  }
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

template <typename T, typename Q, int THREADS, int TR>
cudaError_t launch(const Args& a, const void* k, const void* v, const float* k_scale, const float* v_scale,
                   int sc_stride, int B, int C, int smem, cudaStream_t st) {
  auto kernel = decode_attention_kernel<T, Q, THREADS, TR>;
  static unsigned configured = 0u;  // one bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 32 && !(configured & (1u << dev))) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShared);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    configured |= 1u << dev;
  }
  EncodeTiled encode = encoder();
  if (!encode) return cudaErrorNotSupported;
  Maps maps;
  const cuuint64_t dims[3] = {(cuuint64_t)a.H * kD, (cuuint64_t)a.R, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)a.H * kD * sizeof(T), (cuuint64_t)C * a.H * kD * sizeof(T)};
  constexpr cuuint32_t kBoxRows = Geo<T, THREADS, TR>::BOX;
  const cuuint32_t box[3] = {kD, kBoxRows, 1}, unit[3] = {1, 1, 1};
  for (int i = 0; i < 2; ++i)
    if (encode(i ? &maps.v : &maps.k, Vec<T>::kMapType, 3, const_cast<void*>(i ? v : k), dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  if (Vec<T>::kScaled) {
    const cuuint64_t sdims[2] = {(cuuint64_t)a.R, (cuuint64_t)B}, sstrides[1] = {(cuuint64_t)sc_stride * 4};
    const cuuint32_t sbox[2] = {kBoxRows, 1};
    for (int i = 0; i < 2; ++i)
      if (encode(i ? &maps.vs : &maps.ks, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                 const_cast<float*>(i ? v_scale : k_scale), sdims, sstrides, sbox, unit,
                 CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return cudaErrorInvalidValue;
  }
  if (a.split == 1) {
    kernel<<<B * a.H, THREADS, smem, st>>>(maps, a);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * a.H * a.split);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = a.split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  void* args[] = {&maps, const_cast<Args*>(&a)};
  e = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Block widths of 128, 256 or 512 threads (ops/batch_attention.py:
// launch_config); a tile holds threads / 2 rows (half that for a float32
// cache): 8 KB at 128 threads, 32 KB at 512.
template <typename T, typename Q>
cudaError_t launch_width(int threads, const Args& a, const void* k, const void* v, const float* ks, const float* vs,
                         int sc_stride, int B, int C, int smem, cudaStream_t st) {
  constexpr int kHalf = sizeof(T) == 4 ? 2 : 1;
  switch (threads) {
    case 128: return launch<T, Q, 128, 64 / kHalf>(a, k, v, ks, vs, sc_stride, B, C, smem, st);
    case 256: return launch<T, Q, 256, 128 / kHalf>(a, k, v, ks, vs, sc_stride, B, C, smem, st);
    case 512: return launch<T, Q, 512, 256 / kHalf>(a, k, v, ks, vs, sc_stride, B, C, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_q(int q_kind, int threads, const Args& a, const void* k, const void* v, const float* ks,
                     const float* vs, int sc_stride, int B, int C, int smem, cudaStream_t st) {
  switch (q_kind) {
    case 0: return launch_width<T, float>(threads, a, k, v, ks, vs, sc_stride, B, C, smem, st);
    case 1: return launch_width<T, bf16>(threads, a, k, v, ks, vs, sc_stride, B, C, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// kind: 0 float32, 1 bf16, 2 int8 cache; q_kind: 0 float32, 1 bf16 query
// (and output). q [B, H, 1, 64] at strides q_sb, q_sh; k, v [B, C, H, 64],
// 16-byte aligned; slot_pos rows of stride sp_stride (R used); qpos [B];
// k_scale / v_scale rows of stride sc_stride, a multiple of 4 (int8 only,
// else null); out [B, H, 64]. 0 < R <= C; threads: 128, 256 or 512;
// 2 <= stages <= 16; 1 <= split <= 8 blocks per (stream, head), each of
// chunk rows (split - 1) * chunk < R <= split * chunk; smem: the dynamic
// shared memory of one block, as ops/batch_attention.py:shared_bytes
// computes it for chunk rows.
extern "C" int ptt_batch_decode_attention(const void* q, int q_kind, int q_sb, int q_sh, const void* k,
                                          const void* v, int kind, const int* slot_pos, int sp_stride,
                                          const int* qpos, const float* k_scale, const float* v_scale,
                                          int sc_stride, int B, int C, int H, int R, int threads, int stages, int split,
                                          int chunk, int smem, void* out, void* stream) {
  if (R <= 0 || R > C || stages < 2 || stages > 16 || smem > kMaxShared || split < 1 || split > kMaxSplit ||
      chunk <= 0 || (long long)split * chunk < R || (long long)(split - 1) * chunk >= R)
    return (int)cudaErrorInvalidValue;
  const Args a{q, q_sb, q_sh, slot_pos, sp_stride, qpos, H, R, stages, split, chunk, out};
  cudaStream_t st = (cudaStream_t)stream;
  switch (kind) {
    case 0: return (int)launch_q<float>(q_kind, threads, a, k, v, nullptr, nullptr, 0, B, C, smem, st);
    case 1: return (int)launch_q<bf16>(q_kind, threads, a, k, v, nullptr, nullptr, 0, B, C, smem, st);
    case 2: return (int)launch_q<int8_t>(q_kind, threads, a, k, v, k_scale, v_scale, sc_stride, B, C, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

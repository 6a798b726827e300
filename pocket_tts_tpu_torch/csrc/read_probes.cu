// Hopper ports of the two device-memory read probes of the JAX package's
// benchmarks.
//
// stream_read (replaces `make_reader`, benchmarks/bw_probe.py:31, Pallas
// `kern`): out = tok * 1e-20 + sum over the grid blocks b < rows_total /
// blk_rows of x[b*blk_rows + r, c] for r < 8, c < 128, in float32, over
// x [rows_total, 1024] int8, bf16 or float32. The TPU kernel's BlockSpec
// DMAs every byte of each block into VMEM while its body touches one tile;
// a GPU has no block copy that reads bytes nobody uses, so here every thread
// LOADS every 16-byte vector of its share of the blocks: the vectors of the
// contract's tile (rows 0-7, columns 0-127 of each block) are converted and
// summed in shared memory, every other vector is folded into a per-thread
// XOR that a store guarded by a runtime pointer (`sink`, null from the
// wrapper) keeps live, so neither nvcc nor ptxas can drop the loads, and
// nothing but the (8, 128) output is written. Rows past the last whole
// block are not read, as on the TPU.
//
// kv_read_sum (replaces `variant_pallas_read`, benchmarks/attn_micro.py:201,
// Pallas `kern`): out = tok * 1e-20 + sum over rows r < 512 * (rows / 512)
// of k[r] + v[r], per lane, in float32, over kflat, vflat [rows, 1024] bf16,
// viewed as (8, 128). A tail of fewer than 512 rows is not read, as the
// TPU grid (rows // 512) leaves it.
//
// Bound on the H100: the bytes read, at about one operation per byte, so
// the tensor cores do not apply: 256 MiB per stream_read call of the
// bw_probe sweep (80.1 us at 3.35 TB/s), 134.2 MB per kv_read_sum call at
// B=64, C=512 (40.1 us).
//
// Design: blocks walk a grid-stride loop over 64 KiB chunks (stream_read;
// a chunk never crosses a grid block of the TPU kernel, and chunk 0 of each
// holds its tile) or over row pairs (kv_read_sum), each thread keeping
// `kUnroll` 16-byte loads in flight with `ld.global.cs` (evict-first: the
// data is read once). The grid size is an argument, so the probe can sweep
// it. Each block sums its share in shared memory, then adds it into the
// output with one float atomic per element; the C entry zeroes the output
// first (cudaMemsetAsync). The atomics sum the blocks' partials in the order
// they finish, not the TPU's block order, so the result may differ from the
// plain version (sequential over blocks) by float32 rounding only: exactly
// equal for integer-valued data, within 1e-5 of the largest output
// otherwise. Block 0 adds the tok term.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 1024;      // row width of both probes
constexpr int kTileRows = 8;      // rows of the contract's tile
constexpr int kTileCols = 128;    // columns of the contract's tile (and of the output)
constexpr int kOut = kTileRows * kTileCols;
constexpr int kChunkVecs = 4096;  // 64 KiB of 16-byte vectors per stream_read work item
constexpr int kUnroll = 8;        // 16-byte loads in flight per thread
constexpr int kThreads = 256;     // threads per block (both kernels)

__device__ __forceinline__ uint4 load_stream(const uint4* p) { return __ldcs(p); }

__device__ __forceinline__ unsigned fold4(uint4 u) { return u.x ^ u.y ^ u.z ^ u.w; }

// Adds the values of one 16-byte vector of element type T into acc[0..n).
template <typename T>
__device__ __forceinline__ void add_vector(uint4 u, float* acc);

template <>
__device__ __forceinline__ void add_vector<int8_t>(uint4 u, float* acc) {
  const int8_t* p = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] += static_cast<float>(p[i]);
}

template <>
__device__ __forceinline__ void add_vector<__nv_bfloat16>(uint4 u, float* acc) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    acc[2 * i] += f.x;
    acc[2 * i + 1] += f.y;
  }
}

template <>
__device__ __forceinline__ void add_vector<float>(uint4 u, float* acc) {
  acc[0] += __uint_as_float(u.x);
  acc[1] += __uint_as_float(u.y);
  acc[2] += __uint_as_float(u.z);
  acc[3] += __uint_as_float(u.w);
}

// Block 0 adds tok * 1e-20; every block that holds a partial adds it into out.
__device__ __forceinline__ void flush(const float* acc, const float* __restrict__ tok, float* out) {
  for (int i = threadIdx.x; i < kOut; i += blockDim.x) {
    float a = acc[i];
    if (blockIdx.x == 0) a += tok[i] * 1e-20f;
    atomicAdd(out + i, a);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) stream_read_kernel(const uint4* __restrict__ x,
                                                               const float* __restrict__ tok, float* out,
                                                               unsigned* sink, long long blk_vecs,
                                                               long long n_blocks) {
  constexpr int per_vec = 16 / sizeof(T);       // elements per 16-byte vector
  constexpr int row_vecs = kLanes / per_vec;    // vectors per row
  constexpr int tile_vecs = kTileCols / per_vec;  // vectors of a tile row
  constexpr int head_vecs = kTileRows * row_vecs;  // rows 0-7 of a block
  __shared__ float acc[kOut];
  for (int i = threadIdx.x; i < kOut; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  const long long chunks = (blk_vecs + kChunkVecs - 1) / kChunkVecs;
  const long long work = n_blocks * chunks;
  unsigned fold = 0;
  bool has_tile = blockIdx.x == 0;
  for (long long w = blockIdx.x; w < work; w += gridDim.x) {
    const long long b = w / chunks, c = w % chunks;
    const uint4* p = x + b * blk_vecs + c * kChunkVecs;
    const int n = static_cast<int>(blk_vecs - c * kChunkVecs < kChunkVecs ? blk_vecs - c * kChunkVecs
                                                                          : kChunkVecs);
    int start = threadIdx.x;
    if (c == 0) {
      // Rows 0-7: a vector maps to one thread in every block of the grid
      // (v = threadIdx.x + k * blockDim.x), so each tile element of acc is
      // written by one thread only.
      has_tile = true;
      for (int v = threadIdx.x; v < head_vecs; v += blockDim.x) {
        const uint4 u = load_stream(p + v);
        const int cv = v % row_vecs;
        if (cv < tile_vecs)
          add_vector<T>(u, acc + (v / row_vecs) * kTileCols + cv * per_vec);
        else
          fold ^= fold4(u);
      }
      start = head_vecs + threadIdx.x;
    }
    for (int v = start; v < n; v += blockDim.x * kUnroll) {
      uint4 u[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int i = v + k * blockDim.x;
        u[k] = i < n ? load_stream(p + i) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) fold ^= fold4(u[k]);
    }
  }
  if (sink != nullptr) sink[blockIdx.x * blockDim.x + threadIdx.x] = fold;
  __syncthreads();
  if (has_tile) flush(acc, tok, out);
}

// kflat, vflat: rows_used rows of kLanes bf16 (128 vectors a row). Thread t
// owns column vector t % 128 of every row pair's row t / 128, and sums its 8
// columns of K and V over the rows it reads.
__global__ void __launch_bounds__(kThreads) kv_read_sum_kernel(const uint4* __restrict__ k,
                                                               const uint4* __restrict__ v,
                                                               const float* __restrict__ tok, float* out,
                                                               long long rows) {
  constexpr int row_vecs = kLanes / 8;
  constexpr int lanes = kThreads / row_vecs;  // rows read side by side by one block
  __shared__ float acc[lanes][kLanes];
  const int cv = threadIdx.x % row_vecs, lane = threadIdx.x / row_vecs;
  float a[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) a[i] = 0.f;
  const long long step = static_cast<long long>(gridDim.x) * lanes;
  for (long long r0 = static_cast<long long>(blockIdx.x) * lanes + lane; r0 < rows; r0 += step * (kUnroll / 2)) {
    uint4 uk[kUnroll / 2], uv[kUnroll / 2];
#pragma unroll
    for (int j = 0; j < kUnroll / 2; ++j) {
      const long long r = r0 + j * step;
      const bool in = r < rows;
      uk[j] = in ? load_stream(k + r * row_vecs + cv) : make_uint4(0, 0, 0, 0);
      uv[j] = in ? load_stream(v + r * row_vecs + cv) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int j = 0; j < kUnroll / 2; ++j) {
      add_vector<__nv_bfloat16>(uk[j], a);
      add_vector<__nv_bfloat16>(uv[j], a);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[lane][cv * 8 + i] = a[i];
  __syncthreads();
  for (int i = threadIdx.x; i < kLanes; i += blockDim.x) {
    float s = acc[0][i];
#pragma unroll
    for (int l = 1; l < lanes; ++l) s += acc[l][i];
    if (blockIdx.x == 0) s += tok[i] * 1e-20f;
    atomicAdd(out + i, s);
  }
}

}  // namespace

// x [rows_total, 1024] of `kind` (0 float32, 1 bf16, 2 int8), 16-byte
// aligned; tok and out (8, 128) float32; blk_rows >= 8; grid > 0 blocks.
extern "C" int ptt_stream_read(const void* x, int kind, int rows_total, int blk_rows, const float* tok,
                               float* out, int grid, void* stream) {
  static const int kBytes[3] = {4, 2, 1};
  if (kind < 0 || kind > 2 || rows_total <= 0 || blk_rows < kTileRows || grid <= 0)
    return (int)cudaErrorInvalidValue;
  const long long n_blocks = static_cast<long long>(rows_total) / blk_rows;
  const long long blk_vecs = static_cast<long long>(blk_rows) * kLanes * kBytes[kind] / 16;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(out, 0, kOut * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  const uint4* xv = static_cast<const uint4*>(x);
  if (kind == 0)
    stream_read_kernel<float><<<grid, kThreads, 0, s>>>(xv, tok, out, nullptr, blk_vecs, n_blocks);
  else if (kind == 1)
    stream_read_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(xv, tok, out, nullptr, blk_vecs, n_blocks);
  else
    stream_read_kernel<int8_t><<<grid, kThreads, 0, s>>>(xv, tok, out, nullptr, blk_vecs, n_blocks);
  return (int)cudaGetLastError();
}

// kflat, vflat [rows, 1024] bf16, 16-byte aligned; tok and out (8, 128)
// float32; reads rows [0, 512 * (rows / 512)); grid > 0 blocks.
extern "C" int ptt_kv_read_sum(const void* kflat, const void* vflat, int rows, const float* tok, float* out,
                               int grid, void* stream) {
  if (rows < 0 || grid <= 0) return (int)cudaErrorInvalidValue;
  const long long used = static_cast<long long>(rows) / 512 * 512;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(out, 0, kOut * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  kv_read_sum_kernel<<<grid, kThreads, 0, s>>>(static_cast<const uint4*>(kflat), static_cast<const uint4*>(vflat),
                                                tok, out, used);
  return (int)cudaGetLastError();
}

// Hopper ports of the two capability probes of scripts/mosaic_probe.py.
//
// row_write (replaces `k_p1` / `probe_p1`, scripts/mosaic_probe.py:28,41):
// write one bf16 row of a (C, E) cache in place at a row index read on the
// device, leaving every other row as it was. The TPU kernel reads the
// 8-row block around the index, selects the row and writes the block back:
// its DMAs move aligned 8-row tiles. Here one block of E/8 threads stores the
// row with one 16-byte store each and touches no other row; the index is
// loaded by the block itself (the TPU kernel's scalar prefetch), so the
// caller never reads it on the host. The index must lie in [0, C) (a device
// assert).
// Bound: 2*E bytes read and written (2 KiB each at E = 1024), nanoseconds at
// 3.35 TB/s, so the kernel is bound by its launch, by nature.
//
// head_slice_weighted_sum (replaces `k_p2` / `probe_p2`,
// scripts/mosaic_probe.py:79,87): out[c, j] = sum_{h < heads} (h + 1) *
// x[c, h*width + j] over a bf16 (C, heads*width) input, float32 (C, width)
// output, summed in float32 in the order h = 0, 1, ... as the TPU kernel
// does (each term is exact in float32, so the sum is bit-equal to it). Each
// thread owns 8 outputs of one row: per head one 16-byte load of 8 bf16,
// eight FMAs, then two 16-byte stores; the 8 threads of a row cover its
// 128-byte head slices together. Bound: the input read once (128 MiB at
// C = 65536: 40 us at 3.35 TB/s); the 16 MiB float32 output is written into
// the 50 MB L2, whose write-back to HBM can fall after the kernel; 2 ops per
// input element is far below the float32 rate.

#include <assert.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;          // bf16 values per 16-byte vector
constexpr int kSumThreads = 256;  // threads per block of head_slice_weighted_sum

__global__ void row_write_kernel(uint4* __restrict__ cache, const uint4* __restrict__ row,
                                 const int* __restrict__ index, int C, int vecs_per_row) {
  const int r = __ldg(index);
  assert(r >= 0 && r < C);
  uint4* dst = cache + static_cast<size_t>(r) * vecs_per_row;
  for (int i = threadIdx.x; i < vecs_per_row; i += blockDim.x) dst[i] = row[i];
}

__global__ void head_slice_weighted_sum_kernel(const uint4* __restrict__ x, float4* __restrict__ out, int C,
                                               int heads, int width) {
  const int groups = width / kVec;  // threads per row
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(C) * groups) return;
  const int c = static_cast<int>(t / groups), g = static_cast<int>(t % groups);
  const uint4* src = x + (static_cast<size_t>(c) * heads * width) / kVec + g;
  float acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
  for (int h = 0; h < heads; ++h) {
    const uint4 u = __ldg(src + static_cast<size_t>(h) * groups);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
    const float w = static_cast<float>(h + 1);
#pragma unroll
    for (int i = 0; i < kVec / 2; ++i) {
      const float2 f = __bfloat1622float2(p[i]);
      acc[2 * i] = fmaf(f.x, w, acc[2 * i]);
      acc[2 * i + 1] = fmaf(f.y, w, acc[2 * i + 1]);
    }
  }
  float4* dst = out + (static_cast<size_t>(c) * width) / 4 + 2 * g;
  dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
}

}  // namespace

// cache [C, E] bf16 (written in place), row [E] bf16, index [1] int32, all on
// the device; E % 8 == 0 and both pointers 16-byte aligned.
extern "C" int ptt_row_write(void* cache, const void* row, const int* index, int C, int E, void* stream) {
  if (C <= 0 || E <= 0 || E % kVec) return (int)cudaErrorInvalidValue;
  const int vecs = E / kVec;
  const int threads = vecs < 1024 ? vecs : 1024;
  row_write_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(static_cast<uint4*>(cache),
                                                           static_cast<const uint4*>(row), index, C, vecs);
  return (int)cudaGetLastError();
}

// x [C, heads*width] bf16, out [C, width] float32; width % 8 == 0 and both
// pointers 16-byte aligned.
extern "C" int ptt_head_slice_weighted_sum(const void* x, float* out, int C, int heads, int width, void* stream) {
  if (C <= 0 || heads <= 0 || width <= 0 || width % kVec) return (int)cudaErrorInvalidValue;
  const long long threads = static_cast<long long>(C) * (width / kVec);
  const int blocks = static_cast<int>((threads + kSumThreads - 1) / kSumThreads);
  head_slice_weighted_sum_kernel<<<blocks, kSumThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint4*>(x), reinterpret_cast<float4*>(out), C, heads, width);
  return (int)cudaGetLastError();
}

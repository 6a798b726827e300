// Hopper port of the JAX package's fused_backbone_step
// (pocket_tts_tpu/ops/fused_backbone.py:fused_backbone_step, Pallas kernel
// `_kernel`, one Mosaic program per frame on a grid of (L, phases)): one B=1
// FlowLM decode frame — BOS/latent select, the int8 input projection, 6
// pre-LN layers with int8 weight-only matmuls, RoPE, attention over the
// slot-major cache with in-place (k, v) appends at widx, then out_norm, the
// EOS logit and the slot_pos append.
//
// What bounds it on the H100: bytes. The frame reads the 75.5 MB of int8
// weights once, plus the valid KV rows (about 23 us at 3.35 TB/s), and each
// weight byte meets one multiply-add (B=1), so the tensor cores do not
// apply. What the design does about it: one cooperative launch per call,
// the segment kernel's frame without its flow head (persistent_frame.cuh).
// One 512-thread block per SM (every block the occupancy allows, all
// resident) walks 6 L + 2 phases — the input projection; per layer qkv,
// scores, pv, o, ff1, ff2; the head — with a grid barrier between two
// phases: 38 phases and 37 barriers at 6 layers, where the form this
// replaces launched 32 kernels. Each weight phase spreads its rows evenly
// over the blocks, whose rows a bulk copy brings into a two-slot ring in
// shared memory while the phase before runs; the attention is split over
// (head, chunk of cache rows) items over the whole grid. In the head, after
// the last barrier, block 0 computes out_norm in float32, writes h, the EOS
// logit and slot_pos[widx] = qpos.
// What bounds it in practice: latency, not bytes. Each phase waits on a few
// L2 round trips (the barrier's arrival and release, the prologue's vector),
// as in the segment kernel; PERF.md has the measurements.

#include "persistent_frame.cuh"

namespace ptt {

struct StepArgs {
  const float* x_in;        // the input row [ldim]: the BOS embedding or the latent
  float* h_out;             // [E]
  float* eos_out;           // [1]
  AttnSplit split;          // the attention items and their partials
  const int* plan;          // [K_BACKBONE][G + 1] row starts per block, then [G + 1] item starts
  unsigned long long* ctr;  // the grid barrier's counter
  int qpos, widx;           // widx clamped to C - 1 by the caller
  int slot_bytes;           // one of the weight ring's two slots, at offset 0 of dynamic shared memory
  int xs_off, sc_off;       // dynamic shared memory: the activation, the items' scores
};

// out_norm (LayerNorm, eps 1e-5) of the residual -> h in float32, the EOS
// logit and the slot_pos append, by one block after the last barrier.
__device__ __forceinline__ void head_out(const PttBackbone& a, const StepArgs& g, float* red) {
  const int E = a.E, tid = threadIdx.x;
  float v[pd::kVecPer];
  pd::load_vec(a.x, E, v);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < pd::kVecPer; ++k) s += v[k];
  const float mean = pd::block_sum_i(s, red) / (float)E;
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < pd::kVecPer; ++k) {
    const float c = tid + k * pd::kThreads < E ? v[k] - mean : 0.f;
    q += c * c;
  }
  const float rstd = rsqrtf(pd::block_sum_i(q, red) / (float)E + 1e-5f);
  float e = 0.f;
#pragma unroll
  for (int k = 0; k < pd::kVecPer; ++k) {
    const int i = tid + k * pd::kThreads;
    if (i >= E) continue;
    const float hn = (v[k] - mean) * rstd * a.out_norm[i] + a.out_norm[E + i];
    g.h_out[i] = hn;
    e += hn * a.eos_w[i];
  }
  e = pd::block_sum_i(e, red);
  if (tid == 0) {
    g.eos_out[0] = e + a.eos_b[0];
    a.slot_pos[g.widx] = g.qpos;
  }
}

__global__ void __launch_bounds__(pd::kThreads, 1) backbone_step_kernel(const __grid_constant__ PttBackbone a,
                                                                      const __grid_constant__ StepArgs g) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem + g.xs_off);
  float* sc = reinterpret_cast<float*>(smem + g.sc_off);
  __shared__ float red[32];
  __shared__ float qf[kHeadDim], kf[kHeadDim], vf[kHeadDim];
  __shared__ float pvr[pd::kWarps][kHeadDim];
  __shared__ __align__(8) unsigned long long ring_bars[2];
  __shared__ int rows_sh[2 * K_BACKBONE];  // this block's row range of each matrix
  __shared__ pd::Gemv gd;                  // the GEMV of the running phase

  const int tid = threadIdx.x, G = gridDim.x, blk = blockIdx.x, L = a.L;
  const int* items = g.plan + K_BACKBONE * (G + 1);
  const int it0 = __ldg(items + blk), it1 = __ldg(items + blk + 1);
  if (tid < 2 * K_BACKBONE) rows_sh[tid] = __ldg(g.plan + (tid >> 1) * (G + 1) + blk + (tid & 1));
  const uint32_t bar0 = pd::smem_addr(&ring_bars[0]);
  const WeightRing ring{smem, bar0, g.slot_bytes, 4 * L + 1, rows_sh};
  auto describe = [&](int wp, pd::Gemv& x) {
    x = pd::Gemv{};
    describe_backbone(a, g.split, wp, g.x_in, x);
  };
  auto describe_j = [&](int j, pd::Gemv (&d)[2]) {
    describe(j, d[0]);
    return 1;
  };
  if (tid == 0) {
    for (int k = 0; k < 2; ++k) pd::mbar_init(bar0 + 8 * k, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int head = 6 * L + 1;  // the last phase, after the backbone's (phase_kind)
  __syncthreads();  // rows_sh and the mbarriers
  if (tid == 0) {
    ring.issue(0, describe_j);
    ring.issue(1, describe_j);
    describe(0, gd);
  }
  __syncthreads();

  pd::GridBarrier bar;
  bar.init(g.ctr);
  int j = 0;  // weight phases begun
  for (int ph = 0; ph < head; ++ph) {
    const int l = (ph - 1) / 6;
    int wp = 0;
    const int kind = phase_kind(ph, L, &wp);
    if (kind == 1) {
      attn_scores(a, g.split, l, it0, it1, g.qpos, g.widx, sc, red, qf, kf, vf);
    } else if (kind == 2) {
      attn_pv(a, g.split, l, it0, it1, sc, pvr);
    } else {
      pd::gemv(gd, rows_sh[2 * gd.kind], rows_sh[2 * gd.kind + 1], xs, ring.slot(j), ring.bar(j), ring.parity(j),
               red);
      ++j;
    }
    // In the barrier thread 0 requests the weights of the weight phase after
    // the next one and describes the next phase.
    bar.sync([&] {
      if (kind == 0) ring.issue(j + 1, describe_j);
      int next = 0;
      if (ph + 1 < head && phase_kind(ph + 1, L, &next) == 0) describe(next, gd);
    });
  }
  if (blk == 0) head_out(a, g, red);
  bar.finish();
}

static int smem_set[64];  // the dynamic shared memory allowed so far, per device

}  // namespace ptt

// Blocks of the kernel one SM holds at `smem` bytes of dynamic shared memory.
extern "C" int ptt_fused_backbone_occupancy(int smem, int* blocks_per_sm) {
  int e = ptt::set_shared_bytes((const void*)ptt::backbone_step_kernel, smem, ptt::smem_set);
  if (e) return e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, ptt::backbone_step_kernel,
                                                            ptt::pd::kThreads, (size_t)smem);
}

// One cooperative launch of `grid` blocks (all resident) for one frame; the
// plan and the shared-memory layout come from ops/persistent.segment_plan.
extern "C" int ptt_fused_backbone_step(const PttBackbone* a, const float* latent, int is_bos, int qpos, int widx,
                                       float* h_out, float* eos_out, const int* plan, int grid, int chunk, int nch,
                                       int slot_bytes, int xs_off, int sc_off, int smem, float* part, float* stats,
                                       unsigned long long* ctr, void* stream) {
  int e = ptt::set_shared_bytes((const void*)ptt::backbone_step_kernel, smem, ptt::smem_set);
  if (e) return e;
  ptt::StepArgs g{is_bos ? a->bos : latent, h_out, eos_out, {part, stats, chunk, nch}, plan, ctr, qpos, widx,
                  slot_bytes, xs_off, sc_off};
  void* args[] = {(void*)a, (void*)&g};
  return (int)cudaLaunchCooperativeKernel((const void*)ptt::backbone_step_kernel, dim3(grid),
                                          dim3(ptt::pd::kThreads), args, (size_t)smem, (cudaStream_t)stream);
}

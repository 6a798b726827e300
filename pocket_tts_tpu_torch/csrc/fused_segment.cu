// Hopper port of the JAX package's fused_segment_decode
// (pocket_tts_tpu/ops/fused_segment.py:fused_segment_decode, Pallas kernel
// `_seg_kernel`, one Mosaic program on a grid of (S, 52) phases): S
// autoregressive FlowLM frames, each the backbone frame of fused_backbone.cu
// (its phases from persistent_frame.cuh) followed by the flow-matching head (one Euler step, s=0, t=1, of
// SimpleMLPAdaLN on bf16 weights with float32 accumulation) whose latent
// (noise + velocity) feeds the next frame. Later frames read the (k, v) rows
// earlier frames appended.
//
// What bounds it on the H100: bytes. Each frame reads the 75.5 MB of int8
// backbone weights and about 20 MB of bf16 flow weights once, plus the
// valid KV rows, and each weight byte meets one multiply-add (B=1), so the
// tensor cores do not apply: at 3.35 TB/s a frame takes at least ~29 us.
// What the design does about it:
//  - One cooperative launch per call runs all S frames: one block per SM
//    (every block the occupancy allows, all resident) walks 52 phases a
//    frame with a grid barrier after each (persistent_decode.cuh), so no
//    host call or launch gap sits between two phases.
//  - Every weight phase spreads its matrix rows evenly over all blocks (the
//    row table of ops/persistent.segment_plan). Thread 0 of a block
//    copies its rows of the next weight phase into a ring in shared memory
//    (one bulk copy per matrix, during the grid barrier before the phase
//    that precedes it), so the bytes travel while a phase computes and
//    while the barrier waits; warps then read them from shared memory.
//  - Attention is split over the cache rows: (head, chunk) items over the
//    blocks, in two phases so the softmax weights round to bf16 after the
//    global normalisation, exactly where the plain version rounds them.
//    Scores: each item keeps its chunk's scores in shared memory and
//    publishes the chunk max and sum of exp; chunk 0's item rotates q/k,
//    adds the self score and writes the new (k, v) row at widx (masked from
//    every read this frame). PV: each item combines its head's chunk
//    statistics, rounds its weights and publishes a [64] partial; the
//    out-projection's prologue sums them in chunk order.
//  - Each block writes only rows it owns; data written during the launch is
//    read through L2 after the barrier that published it.
// What bounds it in practice on an H100: latency, not bytes. Each of the 52
// phases of a frame waits on a few L2 round trips (the barrier's arrival
// and release, the prologue's vector), so a frame takes several times the
// byte bound; PERF.md has the measurements.

#include "persistent_frame.cuh"

namespace ptt {

// The flow head's weight matrices, after the backbone's in the row table
// (ops/persistent.py KINDS).
enum FlowKind { K_COND = K_BACKBONE, K_FIN, K_ADA, K_W0, K_W2, K_FINAL, K_COUNT };

struct SegArgs {
  const float* latent;     // [ldim] carry (ignored at BOS)
  const float* noise;      // [S, ldim]
  float* latents_out;      // [S, ldim]
  float* eos_out;          // [S]
  AttnSplit split;         // the attention items and their partials
  const int* plan;         // [K_COUNT][G + 1] row starts per block, then [G + 1] item starts
  unsigned long long* ctr; // the grid barrier's counter
  int S, qpos0, widx0, is_bos;
  int slot_bytes;          // one of the weight ring's two slots, at offset 0 of dynamic shared memory
  int xs_off, xs2_off, sc_off;  // dynamic shared memory: the activations, the items' scores
};

__device__ __forceinline__ int align128(int n) { return (n + 127) & ~127; }

// The GEMVs of weight phase wp (0 .. 4L + 2 depth + 3) of frame s, into d;
// returns how many (the head phase has two: cond from out_norm(x) and the
// flow's input projection of the noise). The order: the backbone's
// (describe_backbone); head; the AdaLN stack; per flow block w0, w2; the
// final projection.
__device__ __forceinline__ int describe(const PttBackbone& a, const PttFlow& f, const SegArgs& g, const int* rows,
                                        int wp, int s, int qpos, int widx, pd::Gemv (&d)[2]) {
  const int E = a.E, ldim = a.ldim, MC = f.MC;
  const float* noise = g.noise + (size_t)s * ldim;
  pd::Gemv& x = d[0];
  x = pd::Gemv{};
  if (wp <= 4 * a.L) {  // input projection of the previous latent (or BOS), then the layers
    describe_backbone(a, g.split, wp, s > 0 ? g.latents_out + (size_t)(s - 1) * ldim : (g.is_bos ? a.bos : g.latent),
                      x);
    return 1;
  }
  int q = wp - 1 - 4 * a.L;
  x.bf16w = 1;
  if (q == 0) {  // out_norm -> cond(h) + tcomb, block 0: the EOS logit and the slot_pos append
    x.pro.mode = pd::P_NORM; x.pro.x = a.x; x.pro.w = a.out_norm; x.pro.b = a.out_norm + E; x.pro.eps = 1e-5f;
    x.pro.dot_w = a.eos_w; x.pro.dot_b = a.eos_b; x.pro.dot_out = g.eos_out + s;
    x.pro.store_at = a.slot_pos + widx; x.pro.store_val = qpos;
    x.epi.mode = pd::E_STORE; x.epi.out = f.y; x.epi.bias = f.bc; x.epi.bias2 = f.tcomb;
    x.w = f.wc; x.kind = K_COND; x.K = E;
    pd::Gemv& y = d[1];  // input_proj(noise), its rows after cond's in the ring
    y = pd::Gemv{};
    y.pro.mode = pd::P_CAST; y.pro.x = noise;
    y.epi.mode = pd::E_STORE; y.epi.out = f.fx; y.epi.bias = f.b_in;
    y.w = f.win; y.kind = K_FIN; y.K = ldim; y.bf16w = 1; y.second = 1;
    y.woff = align128((rows[2 * K_COND + 1] - rows[2 * K_COND]) * E * 2);
    return 2;
  }
  if (q == 1) {  // every flow block's (shift, scale, gate) and the final (shift, scale) from silu(y)
    x.pro.mode = pd::P_SILU; x.pro.x = f.y;
    x.epi.mode = pd::E_STORE; x.epi.out = f.ada; x.epi.bias = f.ba;
    x.w = f.wa; x.kind = K_ADA; x.K = MC;
    return 1;
  }
  q -= 2;
  if (q < 2 * f.depth) {
    const int i = q / 2;
    const float* ada = f.ada + (size_t)i * 3 * MC;
    if (q % 2 == 0) {  // AdaLN + w0 + SiLU
      x.pro.mode = pd::P_NORM; x.pro.x = f.fx; x.pro.w = f.lnw + (size_t)i * MC; x.pro.b = f.lnb + (size_t)i * MC;
      x.pro.eps = 1e-6f; x.pro.shift = ada; x.pro.scale = ada + MC;
      x.epi.mode = pd::E_SILU; x.epi.out = f.u; x.epi.bias = f.b0 + (size_t)i * MC;
      x.w = f.w0 + (size_t)i * MC * MC; x.kind = K_W0;
    } else {  // w2 + gated residual
      x.pro.mode = pd::P_CAST; x.pro.x = f.u;
      x.epi.mode = pd::E_ADD; x.epi.out = f.fx; x.epi.bias = f.b2 + (size_t)i * MC; x.epi.gate = ada + 2 * MC;
      x.w = f.w2 + (size_t)i * MC * MC; x.kind = K_W2;
    }
    x.K = MC;
    return 1;
  }
  // affine-free final LN, modulate, output projection, Euler update from x0 = noise
  const float* ada = f.ada + (size_t)f.depth * 3 * MC;
  x.pro.mode = pd::P_NORM; x.pro.x = f.fx; x.pro.eps = 1e-6f; x.pro.shift = ada; x.pro.scale = ada + MC;
  x.epi.mode = pd::E_FINAL; x.epi.out = g.latents_out + (size_t)s * ldim; x.epi.bias = f.bf; x.epi.base = noise;
  x.w = f.wf; x.kind = K_FINAL; x.K = MC;
  return 1;
}

__global__ void __launch_bounds__(pd::kThreads, 1) segment_decode_kernel(const __grid_constant__ PttBackbone a,
                                                                       const __grid_constant__ PttFlow f,
                                                                       const __grid_constant__ SegArgs g) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem + g.xs_off);
  bf16* xs2 = reinterpret_cast<bf16*>(smem + g.xs2_off);
  float* sc = reinterpret_cast<float*>(smem + g.sc_off);
  __shared__ float red[32];
  __shared__ float qf[kHeadDim], kf[kHeadDim], vf[kHeadDim];
  __shared__ float pvr[pd::kWarps][kHeadDim];
  __shared__ __align__(8) unsigned long long ring_bars[2];
  __shared__ int rows_sh[2 * K_COUNT];  // this block's row range of each matrix
  __shared__ pd::Gemv gd[2];            // the GEMVs of the running phase
  __shared__ int gd_n;

  const int tid = threadIdx.x, G = gridDim.x, blk = blockIdx.x, L = a.L, C = a.C;
  const int* items = g.plan + K_COUNT * (G + 1);
  const int it0 = __ldg(items + blk), it1 = __ldg(items + blk + 1);
  if (tid < 2 * K_COUNT) rows_sh[tid] = __ldg(g.plan + (tid >> 1) * (G + 1) + blk + (tid & 1));
  const uint32_t bar0 = pd::smem_addr(&ring_bars[0]);
  const int wphases = 4 * L + 2 * f.depth + 4;
  const WeightRing ring{smem, bar0, g.slot_bytes, g.S * wphases, rows_sh};
  // Weight phase j of the launch: weight phase j % wphases of frame j / wphases.
  auto describe_j = [&](int j, pd::Gemv (&d)[2]) {
    const int s = j / wphases;
    return describe(a, f, g, rows_sh, j % wphases, s, g.qpos0 + s, min(g.widx0 + s, C - 1), d);
  };
  if (tid == 0) {
    for (int k = 0; k < 2; ++k) pd::mbar_init(bar0 + 8 * k, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // A frame: the backbone's phases (phase_kind), then head; ada; per flow
  // block w0, w2; final: the TPU grid's 52 at b6369a24.
  const int phases = 6 * L + 2 * f.depth + 4;
  // Thread 0: the GEMVs of frame s's phase ph into gd, if it is a weight phase.
  auto prepare = [&](int s, int ph) {
    int wp = 0;
    if (phase_kind(ph, L, &wp) == 0)
      gd_n = describe(a, f, g, rows_sh, wp, s, g.qpos0 + s, min(g.widx0 + s, C - 1), gd);
  };
  __syncthreads();  // rows_sh and the mbarriers
  if (tid == 0) {
    ring.issue(0, describe_j);
    ring.issue(1, describe_j);
    prepare(0, 0);
  }
  __syncthreads();

  pd::GridBarrier bar;
  bar.init(g.ctr);
  int j = 0;  // weight phases begun
  for (int s = 0; s < g.S; ++s) {
    const int qpos = g.qpos0 + s;
    const int widx = min(g.widx0 + s, C - 1);
    for (int ph = 0; ph < phases; ++ph) {
      const int l = (ph - 1) / 6;
      int wp = 0;
      const int kind = phase_kind(ph, L, &wp);
      if (kind == 1) {
        attn_scores(a, g.split, l, it0, it1, qpos, widx, sc, red, qf, kf, vf);
      } else if (kind == 2) {
        attn_pv(a, g.split, l, it0, it1, sc, pvr);
      } else {
        for (int m = 0; m < gd_n; ++m) {
          const pd::Gemv& d = gd[m];
          pd::gemv(d, rows_sh[2 * d.kind], rows_sh[2 * d.kind + 1], d.second ? xs2 : xs, ring.slot(j) + d.woff,
                   ring.bar(j), ring.parity(j), red);
        }
        ++j;
      }
      if (s + 1 < g.S || ph + 1 < phases) {
        // In the barrier thread 0 requests the weights of the weight phase
        // after the next one and describes the next phase.
        bar.sync([&] {
          if (kind == 0) ring.issue(j + 1, describe_j);
          if (ph + 1 < phases) prepare(s, ph + 1);
          else prepare(s + 1, 0);
        });
      }
    }
  }
  bar.finish();
}

static int smem_set[64];  // the dynamic shared memory allowed so far, per device

}  // namespace ptt

// Blocks of the kernel one SM holds at `smem` bytes of dynamic shared memory.
extern "C" int ptt_fused_segment_occupancy(int smem, int* blocks_per_sm) {
  int e = ptt::set_shared_bytes((const void*)ptt::segment_decode_kernel, smem, ptt::smem_set);
  if (e) return e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, ptt::segment_decode_kernel,
                                                            ptt::pd::kThreads, (size_t)smem);
}

// One cooperative launch of `grid` blocks (all resident) for S frames; the
// plan and the shared-memory layout come from ops/persistent.segment_plan.
extern "C" int ptt_fused_segment_decode(const PttBackbone* a, const PttFlow* f, const float* latent, int is_bos,
                                        const float* noise, int S, int qpos0, int widx0, float* latents_out,
                                        float* eos_out, const int* plan, int grid, int chunk, int nch,
                                        int slot_bytes, int xs_off, int xs2_off, int sc_off, int smem, float* part,
                                        float* stats, unsigned long long* ctr, void* stream) {
  int e = ptt::set_shared_bytes((const void*)ptt::segment_decode_kernel, smem, ptt::smem_set);
  if (e) return e;
  ptt::SegArgs g{latent, noise, latents_out, eos_out, {part, stats, chunk, nch}, plan, ctr, S, qpos0, widx0,
                 is_bos, slot_bytes, xs_off, xs2_off, sc_off};
  void* args[] = {(void*)a, (void*)f, (void*)&g};
  return (int)cudaLaunchCooperativeKernel((const void*)ptt::segment_decode_kernel, dim3(grid),
                                          dim3(ptt::pd::kThreads), args, (size_t)smem, (cudaStream_t)stream);
}

// Hopper port of the JAX package's fused_segment_decode
// (pocket_tts_tpu/ops/fused_segment.py:fused_segment_decode, Pallas kernel
// `_seg_kernel`, one Mosaic program on a grid of (S, 52) phases): S
// autoregressive FlowLM frames, each the backbone frame of fused_backbone.cu
// followed by the flow-matching head (one Euler step, s=0, t=1, of
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
//    row table of ops/fused_segment.segment_plan). Thread 0 of a block
//    copies its rows of the next weight phase into a ring in shared memory
//    (one bulk copy per matrix, during the grid barrier before the phase
//    that precedes it), so the bytes travel while a phase computes and
//    while the barrier waits; warps then read them from shared memory.
//  - Attention is split over the cache rows: (head, chunk) items over the
//    blocks, in two phases so the softmax weights round to bf16 after the
//    global normalisation, exactly where attn_decode_kernel and the plain
//    version round them. Scores: each item keeps its chunk's scores in
//    shared memory and publishes the chunk max and sum of exp; chunk 0's
//    item rotates q/k, adds the self score and writes the new (k, v) row at
//    widx (masked from every read this frame). PV: each item combines its
//    head's chunk statistics, rounds its weights and publishes a [64]
//    partial; the out-projection's prologue sums them in chunk order.
//  - Each block writes only rows it owns; data written during the launch is
//    read through L2 after the barrier that published it.
// What bounds it in practice on an H100: latency, not bytes. Each of the 52
// phases of a frame waits on a few L2 round trips (the barrier's arrival
// and release, the prologue's vector), so a frame takes several times the
// byte bound; PERF.md has the measurements.

#include "persistent_decode.cuh"

namespace ptt {

using pd::kMaxChunks;

// Weight matrices, in the order of the row table (ops/fused_segment.py KINDS).
enum Kind { K_IN = 0, K_QKV, K_O, K_FF1, K_FF2, K_COND, K_FIN, K_ADA, K_W0, K_W2, K_FINAL, K_COUNT };

struct SegArgs {
  const float* latent;     // [ldim] carry (ignored at BOS)
  const float* noise;      // [S, ldim]
  float* latents_out;      // [S, ldim]
  float* eos_out;          // [S]
  float* part;             // [items, 64] attention partial outputs
  float* stats;            // [items, 2] chunk max, chunk sum of exp
  const int* plan;         // [K_COUNT][G + 1] row starts per block, then [G + 1] item starts
  unsigned long long* ctr; // the grid barrier's counter
  int S, qpos0, widx0, is_bos;
  int chunk, nch;          // cache rows per attention item, items per head
  int slot_bytes;          // one of the weight ring's two slots, at offset 0 of dynamic shared memory
  int xs_off, xs2_off, sc_off;  // dynamic shared memory: the activations, the items' scores
};

__device__ __forceinline__ int align128(int n) { return (n + 127) & ~127; }



// Attention scores of layer l for this block's (head, chunk) items [it0, it1):
// RoPE of q (and, for chunk 0, of k), the chunk's scores into sc (the self
// score at [chunk]), the chunk max and sum of exp published to stats, and
// (chunk 0) the new (k, v) row written at widx.
__device__ __forceinline__ void attn_scores(const PttBackbone& a, const SegArgs& g, int l, int it0, int it1,
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
__device__ __forceinline__ void attn_pv(const PttBackbone& a, const SegArgs& g, int l, int it0, int it1, float* sc,
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

// The GEMVs of weight phase wp (0 .. 4L + 2 depth + 3) of frame s, into d;
// returns how many (the head phase has two: cond from out_norm(x) and the
// flow's input projection of the noise). The order: input projection; per
// layer qkv, out, ff1, ff2; head; the AdaLN stack; per flow block w0, w2;
// the final projection.
__device__ __forceinline__ int describe(const PttBackbone& a, const PttFlow& f, const SegArgs& g, const int* rows,
                                        int wp, int s, int qpos, int widx, pd::Gemv (&d)[2]) {
  const int E = a.E, FF = a.FF, ldim = a.ldim, MC = f.MC;
  const float* noise = g.noise + (size_t)s * ldim;
  pd::Gemv& x = d[0];
  x = pd::Gemv{};
  if (wp == 0) {  // input projection of the previous latent (or BOS)
    x.pro.mode = pd::P_CAST;
    x.pro.x = s > 0 ? g.latents_out + (size_t)(s - 1) * ldim : (g.is_bos ? a.bos : g.latent);
    x.epi.mode = pd::E_STORE; x.epi.out = a.x; x.epi.scale = a.s_in;
    x.w = a.win; x.kind = K_IN; x.K = ldim;
    return 1;
  }
  int q = wp - 1;
  if (q < 4 * a.L) {
    const int l = q / 4;
    const float* ln = a.ln + (size_t)l * 4 * E;
    switch (q % 4) {
      case 0:  // LN1 + QKV
        x.pro.mode = pd::P_NORM; x.pro.x = a.x; x.pro.w = ln; x.pro.b = ln + E; x.pro.eps = 1e-5f;
        x.epi.mode = pd::E_STORE; x.epi.out = a.qkv; x.epi.scale = a.sqkv + (size_t)l * 3 * E;
        x.w = a.wqkv + (size_t)l * 3 * E * E; x.kind = K_QKV; x.K = E;
        break;
      case 1:  // out-projection + residual; the prologue sums each head's partials in chunk order
        x.pro.mode = pd::P_PARTS; x.pro.part = g.part; x.pro.chunks = g.nch;
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
    return 1;
  }
  q -= 4 * a.L;
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

// The weight ring: two slots of slot_bytes at offset 0 of shared memory.
// Weight phase j's rows of this block lie in slot j % 2 once mbarrier j % 2
// completes its phase (j / 2) % 2. Thread 0 copies them (one bulk copy per
// matrix) in the grid barrier after weight phase j - 2, the slot's last
// reader, so they travel while weight phase j - 1 runs.
struct WeightRing {
  unsigned char* smem;
  uint32_t bar0;
  int slot_bytes, wphases, total;  // total: weight phases of the launch
  const int* rows;                 // this block's [lo, hi) of each matrix kind

  __device__ unsigned char* slot(int j) const { return smem + (j & 1) * slot_bytes; }
  __device__ uint32_t bar(int j) const { return bar0 + (j & 1) * 8; }
  __device__ uint32_t parity(int j) const { return (uint32_t)((j >> 1) & 1); }

  __device__ __forceinline__ void issue(const PttBackbone& a, const PttFlow& f, const SegArgs& g, int j) const {
    if (j >= total) return;
    const int s = j / wphases;
    pd::Gemv d[2];
    const int n = describe(a, f, g, rows, j % wphases, s, g.qpos0 + s, min(g.widx0 + s, a.C - 1), d);
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
  const WeightRing ring{smem, bar0, g.slot_bytes, wphases, g.S * wphases, rows_sh};
  if (tid == 0) {
    for (int k = 0; k < 2; ++k) pd::mbar_init(bar0 + 8 * k, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int phases = 6 * L + 2 * f.depth + 4;  // a frame: the TPU grid's 52 at b6369a24
  // Phase ph of a frame: in; per layer qkv, scores, pv, o, ff1, ff2; head;
  // ada; per flow block w0, w2; final. Its kind: 1 scores, 2 pv, 0 a weight
  // phase, whose index among the frame's weight phases is *wp.
  auto kind_of = [&](int ph, int* wp) {
    const int l = (ph - 1) / 6, q = (ph - 1) % 6;
    const bool layer = ph >= 1 && ph <= 6 * L;
    if (layer && (q == 1 || q == 2)) return q;
    *wp = ph == 0 ? 0 : layer ? 1 + 4 * l + (q == 0 ? 0 : q - 2) : ph - 2 * L;
    return 0;
  };
  // Thread 0: the GEMVs of frame s's phase ph into gd, if it is a weight phase.
  auto prepare = [&](int s, int ph) {
    int wp = 0;
    if (kind_of(ph, &wp) == 0) gd_n = describe(a, f, g, rows_sh, wp, s, g.qpos0 + s, min(g.widx0 + s, C - 1), gd);
  };
  __syncthreads();  // rows_sh and the mbarriers
  if (tid == 0) {
    ring.issue(a, f, g, 0);
    ring.issue(a, f, g, 1);
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
      const int kind = kind_of(ph, &wp);
      if (kind == 1) {
        attn_scores(a, g, l, it0, it1, qpos, widx, sc, red, qf, kf, vf);
      } else if (kind == 2) {
        attn_pv(a, g, l, it0, it1, sc, pvr);
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
          if (kind == 0) ring.issue(a, f, g, j + 1);
          if (ph + 1 < phases) prepare(s, ph + 1);
          else prepare(s + 1, 0);
        });
      }
    }
  }
  bar.finish();
}

static int set_shared_bytes(int smem) {
  static int set_for[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64 && smem > set_for[dev]) {
    e = cudaFuncSetAttribute(segment_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    set_for[dev] = smem;
  }
  return 0;
}

}  // namespace ptt

// Blocks of the kernel one SM holds at `smem` bytes of dynamic shared memory.
extern "C" int ptt_fused_segment_occupancy(int smem, int* blocks_per_sm) {
  int e = ptt::set_shared_bytes(smem);
  if (e) return e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, ptt::segment_decode_kernel,
                                                            ptt::pd::kThreads, (size_t)smem);
}

// One cooperative launch of `grid` blocks (all resident) for S frames; the
// plan and the shared-memory layout come from ops/fused_segment.segment_plan.
extern "C" int ptt_fused_segment_decode(const PttBackbone* a, const PttFlow* f, const float* latent, int is_bos,
                                        const float* noise, int S, int qpos0, int widx0, float* latents_out,
                                        float* eos_out, const int* plan, int grid, int chunk, int nch,
                                        int slot_bytes, int xs_off, int xs2_off, int sc_off, int smem, float* part,
                                        float* stats, unsigned long long* ctr, void* stream) {
  int e = ptt::set_shared_bytes(smem);
  if (e) return e;
  ptt::SegArgs g{latent, noise, latents_out, eos_out, part, stats, plan, ctr, S, qpos0, widx0, is_bos,
                 chunk, nch, slot_bytes, xs_off, xs2_off, sc_off};
  void* args[] = {(void*)a, (void*)f, (void*)&g};
  return (int)cudaLaunchCooperativeKernel((const void*)ptt::segment_decode_kernel, dim3(grid),
                                          dim3(ptt::pd::kThreads), args, (size_t)smem, (cudaStream_t)stream);
}

// WaveNet autoregressive sampler for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel nspeech_tpu/ops/pallas/wavenet_gen.py
// (PallasWaveNetGenerator._get_fn -> pl.pallas_call, body _make_kernel /
// kernel) in all four of its forms: one-shot (K1: batch 1; K2: batch B>1
// with per-stream global conditioning), priming (K3, prime_len > 0: the
// input of step t < prime_len is the forced seed code) and carried-state
// streaming (K4, carry_io=True); local conditioning (mel) on every
// sample, Gumbel-max sampling or argmax.
//
// One body serves every form. The state a stream carries from one launch
// to the next is its dilation rings, its next input code and the input
// before it ("prev", -1 when the causal conv's past tap is zero), and the
// absolute index t0 of the launch's first sample. A one-shot launch is a
// carried launch from the fresh state (zeroed rings, code Q/2, prev -1,
// t0 = 0). Ring slots and the noise counter use the absolute index
// t0 + t, so launches of any sizes chained over one carry give the codes
// of one launch. Priming reads forced[b, t0 + t] as the input code while
// t0 + t < prime_len; launches without priming pass prime_len = 0. A step
// whose code is thrown away (t0 + t < prime_len - 1: its successor's input
// is forced too) runs only the layer stack, which advances the rings, and
// skips the skip sum, the post-net and the argmax; it stores the next
// forced code instead.
//
// Per sample and per stream: causal one-hot tap -> L gated dilated layers
// (ring read at slot (t0 + t) mod d, fg = [state | current] @ W_chain +
// lc_t @ W_lc + bias, tanh(f)*sigmoid(g), residual update, gated output
// kept for the skip sum) -> skip = gated_all @ W_skip -> ReLU, 1x1, ReLU,
// 1x1 -> logits -> argmax(logits / T + Gumbel) with the lowest-index
// tie-break; the code is the next step's input.
//
// What bounds a step at batch 1, and what the design does about it. The
// work is ~3.4 MFLOP over ~6.9 MB of float32 weights that stay in the
// 50 MB L2, far below the card's roofline (67 TFLOP/s: ~0.05 us). A step
// is bound by the latency of its dependent chain and by how fast the
// cluster's SMs pull weights out of L2.
// - One thread-block cluster of 8 CTAs per stream (grid 8·B, cluster
//   (8,1,1), cudaLaunchKernelEx), looping over every sample inside the
//   kernel. Rank 0 runs the layer chain on one SM, so no layer exchanges
//   anything between SMs; ranks 1-7 take what sits off the chain or after
//   it. Streams beyond the clusters that fit run in waves.
// - lc projection: lc_t @ W_lc (80 of a layer's 144 input rows at full
//   width) depends only on the conditioning, so while rank 0 runs step
//   t's chain, ranks 1-7 compute step t+1's projection for all L layers
//   into a double-buffered [2][L][2DC] array in rank 0's shared memory
//   (distributed shared memory). A prologue computes step 0's. With M = 0
//   the stage is absent.
// - The chain: each layer's dense product is folded into the next layer
//   (as the TPU kernel does), so a layer is one phase and one block
//   barrier: 8 warps compute its 32 (f, g) pairs from [state | previous
//   residual | previous gates] while 8 warps update the residual (its
//   ring entry, the next layer's input). Each warp owns whole pairs or
//   outputs; lanes take 4 consecutive inputs and 3 shuffle rounds sum
//   them, with no serial shared-memory sum. A layer's weights (28 KB at
//   full width) stream through kStages shared-memory stages by bulk
//   copies issued kStages layers ahead by a producer warp, which also
//   waits for the next layer's copy before the barrier, so no L2 round
//   trip and no mbarrier wait stays on the compute warps' path. The next
//   step's ring states are prefetched (cp.async) during the head. What
//   remains is the layer's dependent chain (loads, shuffles, the gate's
//   exponentials, the barrier): ~1,200 cycles per layer measured.
// - The head (skip sum, post-net, argmax: 4.8 MB per kept step) is bound
//   by L2 reads, and the 8 SMs of a cluster share one path to L2 (~40 GB/s
//   each measured when 7 of them stream at once), so ranks 1-7 split its
//   columns and each streams its own contiguous block of the weights
//   through kHeadStages shared-memory chunks by bulk copies, refilled as
//   they are read. The skip sum is linear in the gates, so it runs beside
//   the chain: after each layer's barrier rank 0's producer warp pushes
//   the layer's gates into the head ranks with st.async, which completes
//   a per-layer mbarrier there, and each head rank adds the layer's rows
//   of its skip columns as they arrive. After the chain a cluster barrier
//   (the skip columns all-gathered into the head ranks); each head rank's
//   post1 columns, all-gathered; a barrier; its codes (post2, Gumbel noise,
//   a lowest-index argmax), whose (score, index) goes to rank 0; a
//   barrier; rank 0 reduces the 7 candidates in rank order. Three cluster
//   barriers per kept step, one per thrown-away priming step.
// Every sum has a fixed order and no atomics, so chained launches give
// the codes of one launch. The dilation rings live in a global scratch
// [B, sum(d), R], read and written in place.
//
// Noise: Philox4x32-10 keyed by the 64-bit seed; code q of stream b at
// absolute sample t takes word q % 4 of philox(counter = (q / 4, t, b, 0))
// (t taken mod 2^32).
// u = (bits >> 8) * 2^-24 + 1e-10, g = -log(-log(u)). The plain PyTorch
// version (nspeech_tpu_torch/ops/philox.py) computes the same bits.
//
// Built with -DWAVENET_STAMPS, rank 0 of stream 0 writes %globaltimer
// stamps at the phase boundaries of each of the first kStampSteps steps,
// and clock64 stamps inside its middle layer, into a debug buffer
// (scripts/torch_sampler_ab.py --stamps); the normal build carries none.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kGateWarps = 8;    // rank 0: warps that compute a layer's gates
constexpr int kDenseWarps = 8;   // rank 0: warps that update the residual
constexpr int kChainWarps = kGateWarps + kDenseWarps;
constexpr int kThreads = 32 * (kChainWarps + 1);  // + the weight producer
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;
constexpr int kStages = 4;      // layers of chain weights in flight
constexpr int kHeads = kCluster - 1;  // ranks 1-7 compute the head
constexpr int kHeadStages = 6;  // head weight chunks in flight per rank
constexpr int kChunk = 32768;   // bytes of one head chunk
constexpr int kStampSteps = 64;
// per stamped step: %globaltimer (marks 0-5) on rank 0 at the step start,
// the chain end, after each of the three cluster barriers and at the
// code; clock64 in the middle layer (6 its start, 8 gates done, 9 its
// block barrier passed; 11 and 10 a dense warp's start and end) and on
// rank 1 (12 its skip columns begun, 13 done and gathered, 14 after the
// first cluster barrier, 17 post1 done, 15 after the second, 16 post2
// done)
constexpr int kMarks = 18;

struct Args {
  const float* wc;       // [2, Q, R]   causal taps: [0] past, [1] current
  const float* wchain;   // [L, 2DC, 2R+DC] output-major over [state |
                         // residual | gates] of the layer before (folded)
  const float* wlc;      // [L, M, 2DC] or null when M == 0
  const float* bfg;      // [L, B, 2DC] per-stream bias (biases + gc)
  const float* wdense;   // [L, R, DC] output-major, row l: layer l-1's
  const float* bdense;   // [L, R] row l: layer l-1's
  const float* head;     // per head rank: its columns of W_skip [L*DC, S],
                         // post1 [S, S] and post2 [S, Q], each row-major
  const float* bskip;    // [S]
  const float* b1;       // [S]
  const float* b2;       // [Q]
  const int* dilations;  // [L]
  const float* lc;       // [B, T, M] or null when M == 0
  const int* forced;     // [B, prime_len] seed codes or null when prime_len == 0
  float* rings;          // [B, ring_rows, R] carried: read and written in place
  int* state;            // [B, 2] carried (code, prev): read and written
  int* codes;            // [B, T]
  unsigned long long* stamps;  // [kStampSteps, kMarks] or null
  int B, T, L, R, DC, S, Q, M, ring_rows, prime_len;
  unsigned long long t0;  // absolute index of this launch's first sample
  float inv_temperature;  // <= 0: argmax
  uint32_t seed_lo, seed_hi;
};

__device__ __forceinline__ uint32_t philox_word(uint32_t c0, uint32_t c1,
                                                uint32_t c2, uint32_t c3,
                                                uint32_t k0, uint32_t k1,
                                                int word) {
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return word == 0 ? c0 : word == 1 ? c1 : word == 2 ? c2 : c3;
}

// All threads of the cluster: stores to shared::cluster before it are
// visible after it (release / acquire are the defaults).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

__device__ __forceinline__ void stamp(unsigned long long* stamps, int t,
                                      int mark) {
#ifdef WAVENET_STAMPS
  if (stamps != nullptr && t < kStampSteps) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    stamps[t * kMarks + mark] = ns;
  }
#endif
}

__device__ __forceinline__ void stamp_clock(unsigned long long* stamps, int t,
                                            int mark, bool on) {
#ifdef WAVENET_STAMPS
  if (on && stamps != nullptr && t < kStampSteps)
    stamps[t * kMarks + mark] = (unsigned long long)clock64();
#endif
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// One thread: `bytes` (a multiple of 16, both addresses 16-byte aligned)
// from global to this CTA's shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// tanh(f) * sigmoid(g) in float32 from the exponential intrinsic (about
// 1e-7 absolute error; both saturate correctly at +-inf).
__device__ __forceinline__ float gate_unit(float f, float g) {
  const float th = 1.f - __fdividef(2.f, 1.f + __expf(2.f * f));
  return th * __fdividef(1.f, 1.f + __expf(-g));
}

// The address of `p`'s offset in the shared memory of CTA `rank`.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_addr(p)), "r"(rank));
  return remote;
}

// 16 bytes into CTA `rank`'s shared memory at `dst`'s offset, completing
// 16 transaction bytes on its mbarrier at `bar`'s offset (no fence: the
// waiter sees the data once the barrier's phase completes).
__device__ __forceinline__ void store_remote(float* dst, float4 v, uint64_t* bar,
                                             int rank) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
      "[%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(cluster_addr(dst, rank)),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(cluster_addr(bar, rank))
      : "memory");
}

__device__ __forceinline__ float dot4(float4 x, float4 w, float acc) {
  acc = fmaf(x.x, w.x, acc);
  acc = fmaf(x.y, w.y, acc);
  acc = fmaf(x.z, w.z, acc);
  return fmaf(x.w, w.w, acc);
}

// Every layer's ring state for a step into dst [L*R], by 16-byte
// cp.async (bypassing L1), at the step's slots or, with `next`, at the
// slots of the step after; the caller waits with cp.async.wait_all.
__device__ __forceinline__ void prefetch_states(const float* ring, float* dst,
                                                const int* dil, const int* off,
                                                const int* slot, int L, int R,
                                                bool next) {
  const int r4 = R >> 2;
  for (int i = threadIdx.x; i < L * r4; i += blockDim.x) {
    const int l = i / r4, c = i - l * r4;
    int s = slot[l];
    if (next) s = s + 1 == dil[l] ? 0 : s + 1;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst + l * R + 4 * c)),
                 "l"(ring + (size_t)(off[l] + s) * R + 4 * c)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

// The producer thread: layer instance g (of n_inst; layer l of its step)
// of the chain's weight stream into stage g % kStages, completing on that
// stage's mbarrier.
__device__ __forceinline__ void issue_layer(long long g, int l, long long n_inst,
                                            int wl, int chain_n, int dense_n,
                                            const float* wchain,
                                            const float* wdense, float* wring,
                                            uint64_t* wbar) {
  static_assert((kStages & (kStages - 1)) == 0, "kStages: a power of 2");
  if (g >= n_inst) return;
  const int s = (int)(g & (kStages - 1));
  float* dst = wring + (size_t)s * wl;
  const uint32_t cb = sizeof(float) * chain_n, db = sizeof(float) * dense_n;
  bar_expect(&wbar[s], cb + db);
  bulk_load(dst, wchain + (size_t)l * chain_n, cb, &wbar[s]);
  bulk_load(dst + chain_n, wdense + (size_t)l * dense_n, db, &wbar[s]);
}

// Ranks 1-7: their share [p0, p1) of lc_row @ W_lc ([L, M, F] flattened
// over (l, j)) into dst, rank 0's projection buffer.
__device__ __forceinline__ void project_lc(const float* lc_row,
                                           const float* __restrict__ wlc,
                                           float* lcv, float* dst, int M,
                                           int F, int p0, int p1) {
  for (int i = threadIdx.x; i < M; i += blockDim.x) lcv[i] = lc_row[i];
  __syncthreads();
  for (int o = p0 + threadIdx.x; o < p1; o += blockDim.x) {
    const int l = o / F, j = o - l * F;
    const float* w = wlc + (size_t)l * M * F + j;
    float acc = 0.f;
#pragma unroll 8
    for (int m = 0; m < M; ++m) acc = fmaf(lcv[m], __ldg(w + (size_t)m * F), acc);
    dst[o] = acc;
  }
}

// Head rank h's share [g0, g1) of the n / 4 float4 column groups.
__device__ __forceinline__ void head_groups(int n, int h, int& g0, int& g1) {
  g0 = h * (n >> 2) / kHeads;
  g1 = (h + 1) * (n >> 2) / kHeads;
}

// A head rank's columns of W_skip, post1 and post2 (three row-major
// segments, contiguous in the packed head), streamed through a ring of
// kHeadStages shared-memory chunks by bulk copies. The stream is periodic
// over kept steps, and the producer refills a stage as soon as it is
// read, so the next step's first chunks land while rank 0 runs the chain.
struct HeadStream {
  const float* base[3];
  int rows[3], cols[3], crow[3], nch[3];
  int period;          // chunks per kept step
  float* ring;
  uint64_t* bar;
  int used;            // chunks consumed so far
};

__device__ __forceinline__ void head_issue(const HeadStream& h, int c) {
  int j = c % h.period, seg = 0;
  while (j >= h.nch[seg]) j -= h.nch[seg++];
  const int r0 = j * h.crow[seg];
  const int r1 = min(h.rows[seg], r0 + h.crow[seg]);
  const uint32_t bytes = sizeof(float) * (r1 - r0) * h.cols[seg];
  const int st = c % kHeadStages;
  bar_expect(&h.bar[st], bytes);
  bulk_load(h.ring + st * (kChunk / 4), h.base[seg] + (size_t)r0 * h.cols[seg],
            bytes, &h.bar[st]);
}

// Segment seg of x @ W: k-sliced float4 sums over its chunks as they
// arrive, then one thread per column sums the slices in order. Returns
// the column's sum in threads tid < cols (0 elsewhere).
// With layer_bar (the skip segment, chunks of whole layers of DC rows),
// a chunk is read once rank 0 has pushed its layers' gates.
__device__ __forceinline__ float head_segment(HeadStream& h, int seg,
                                              const float* x, float4* part,
                                              bool producer,
                                              uint64_t* layer_bar = nullptr,
                                              int DC = 1,
                                              uint32_t layer_parity = 0) {
  const int n4 = h.cols[seg] >> 2;
  if (n4 == 0) return 0.f;  // uniform over the block
  int ks = blockDim.x / n4;
  ks = ks < 1 ? 1 : (ks > h.crow[seg] ? h.crow[seg] : ks);
  const int s = threadIdx.x / n4, g = threadIdx.x - s * n4;
  const bool active = s < ks;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < h.nch[seg]; ++j, ++h.used) {
    const int st = h.used % kHeadStages;
    bar_wait(&h.bar[st], (uint32_t)(h.used / kHeadStages) & 1u);
    const float4* w = reinterpret_cast<const float4*>(h.ring + st * (kChunk / 4));
    const int r0 = j * h.crow[seg];
    const int r1 = min(h.rows[seg], r0 + h.crow[seg]);
    if (layer_bar != nullptr)
      for (int l = r0 / DC; l * DC < r1; ++l) bar_wait(&layer_bar[l], layer_parity);
    if (active) {
#pragma unroll 4
      for (int k = r0 + s; k < r1; k += ks) {
        const float xv = x[k];
        const float4 wv = w[(k - r0) * n4 + g];
        acc.x = fmaf(xv, wv.x, acc.x);
        acc.y = fmaf(xv, wv.y, acc.y);
        acc.z = fmaf(xv, wv.z, acc.z);
        acc.w = fmaf(xv, wv.w, acc.w);
      }
    }
    __syncthreads();
    if (producer) {   // the stage is read: the chunk kHeadStages ahead
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      head_issue(h, h.used + kHeadStages);
      if (layer_bar != nullptr)   // these layers' gates: the next kept step's
        for (int l = r0 / DC; l * DC < r1; ++l)
          bar_expect(&layer_bar[l], sizeof(float) * DC);
    }
  }
  if (active) part[s * n4 + g] = acc;
  __syncthreads();
  float v = 0.f;
  if ((int)threadIdx.x < 4 * n4) {
    const float* pf = reinterpret_cast<const float*>(part);
    for (int i = 0; i < ks; ++i) v += pf[i * 4 * n4 + threadIdx.x];
  }
  return v;
}

// Floats of the role-specific region of shared memory: rank 0's chain
// buffers or a head rank's chunk ring, whichever is larger.
__host__ __device__ __forceinline__ int role_floats(int L, int R, int DC,
                                                    int M) {
  const int F = 2 * DC, K = 2 * R + DC;
  const int chain = kStages * (F * K + R * DC) + (M ? 2 * L * F : 0) + L * F +
                    3 * L * R;
  const int ring = kHeadStages * (kChunk / 4);
  return chain > ring ? chain : ring;
}

// kK4 = (2R + DC) / 4 and kD4 = DC / 4 when known at compile time (the
// full-width build), 0 when read from the arguments: with constant bounds
// the layer loops unroll and every shared load of a layer issues before
// the first product that needs it.
template <int kK4, int kD4>
__global__ void __launch_bounds__(kThreads, 1)
    wavenet_sample_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / kCluster;
  const int R = a.R, DC = a.DC, S = a.S, Q = a.Q, M = a.M, L = a.L;
  const int F = 2 * DC, R2 = 2 * R, K = R2 + DC, R4 = round4(R);
  const int K4 = kK4 ? kK4 : K >> 2, D4 = kD4 ? kD4 : DC >> 2;
  const int WL = F * K + R * DC;         // floats of one layer's chain weights

  float4* part = smem4;                  // [kThreads] float4 partial sums
  float* gated = smem + 4 * kThreads;    // [(L+1)*DC] zeros, then each layer's
                                         // gate outputs (rank 0 pushes them)
  float* cur = gated + (L + 1) * DC;     // [2][R4] residual, ping-pong
  float* vec1 = cur + 2 * R4;            // [S] skip sum (all-gathered)
  float* vec2 = vec1 + S;                // [S] post1 out (all-gathered)
  float* lcv = vec2 + S;                 // [round4(M)] lc row (ranks 1-7)
  float* role = lcv + round4(M);         // rank 0: the chain's buffers
  float* wring = role;                   // [kStages][WL] chain weights
  float* proj = wring + kStages * WL;    // [2][L*F] lc projections
  float* bias = proj + (M ? 2 * L * F : 0);  // [L*F] fg bias
  float* bd = bias + L * F;              // [L*R] dense biases
  float* st2 = bd + L * R;               // [2][L*R] ring states, by step parity
  float* hring = role;                   // ranks 1-7: [kHeadStages] chunks
  // head ranks: [L] mbarriers, layer l's gates pushed by rank 0
  uint64_t* gbar = reinterpret_cast<uint64_t*>(role + role_floats(L, R, DC, M));
  int* dil = reinterpret_cast<int*>(gbar + L);  // [L]
  int* off = dil + L;                    // [L] ring row offsets
  int* slot = off + L;                   // [L] this step's ring slot
  __shared__ __align__(8) uint64_t wbar[kStages];
  __shared__ __align__(8) uint64_t hbar[kHeadStages];
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ float cand_v[kCluster];
  __shared__ int cand_i[kCluster];
  __shared__ int code_sh;

  const bool chain = rank == 0;
  // stamp writers: rank 0's thread 0, its first dense warp, rank 1's thread 0
  unsigned long long* stamps = (b == 0 && chain && tid == 0) ? a.stamps : nullptr;
  unsigned long long* stamps_dense =
      (b == 0 && chain && tid == 32 * kGateWarps) ? a.stamps : nullptr;
  unsigned long long* stamps_r1 =
      (b == 0 && rank == 1 && tid == 0) ? a.stamps : nullptr;
  float* ring = a.rings + (size_t)b * a.ring_rows * R;
  const float* lc = M ? a.lc + (size_t)b * a.T * M : nullptr;
  const float* wc_past = a.wc;
  const float* wc_cur = a.wc + (size_t)Q * R;
  // rank 0's buffers, seen from every rank
  float* proj0 = cluster.map_shared_rank(proj, 0);
  float* cand_v0 = cluster.map_shared_rank(cand_v, 0);
  int* cand_i0 = cluster.map_shared_rank(cand_i, 0);
  // a head rank's share of the skip / post1 columns and of the codes, and
  // its stream of their weights (from the packed head, rank by rank)
  int s0 = 0, s1 = 0, q0 = 0, q1 = 0;
  HeadStream hs{};
  const bool head_producer = !chain && tid == 32 * kChainWarps;
  if (rank > 0) {
    const float* blk = a.head;
    for (int h = 0; h < rank; ++h) {
      head_groups(S, h, s0, s1);
      head_groups(Q, h, q0, q1);
      if (h + 1 < rank)
        blk += (size_t)(L * DC + S) * 4 * (s1 - s0) + (size_t)S * 4 * (q1 - q0);
    }
    const int rows[3] = {L * DC, S, S}, cols[3] = {4 * (s1 - s0), 4 * (s1 - s0),
                                                  4 * (q1 - q0)};
    hs.period = 0;
    for (int seg = 0; seg < 3; ++seg) {
      hs.base[seg] = blk;
      blk += (size_t)rows[seg] * cols[seg];
      hs.rows[seg] = rows[seg];
      hs.cols[seg] = cols[seg];
      hs.crow[seg] = cols[seg] ? min(rows[seg], kChunk / (4 * cols[seg])) : 1;
      if (seg == 0)   // whole layers: a chunk waits for its layers' gates
        hs.crow[0] = DC * max(1, hs.crow[0] / DC);
      hs.nch[seg] = cols[seg] ? (rows[seg] + hs.crow[seg] - 1) / hs.crow[seg] : 0;
      hs.period += hs.nch[seg];
    }
    hs.ring = hring;
    hs.bar = hbar;
    hs.used = 0;
    if (head_producer) {
      // one arrival (this thread's, with the DC * 4 bytes it expects) and
      // the bytes of rank 0's pushes complete a layer's phase
      for (int l = 0; l < L; ++l)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                         smem_addr(&gbar[l]))
                     : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int l = 0; l < L; ++l) bar_expect(&gbar[l], sizeof(float) * DC);
    }
    if (head_producer && hs.period) {
      for (int st = 0; st < kHeadStages; ++st)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                         smem_addr(&hbar[st]))
                     : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int c = 0; c < kHeadStages; ++c) head_issue(hs, c);
    }
  }
  const int n_proj = L * F;
  const int p0 = chain ? 0 : (rank - 1) * n_proj / (kCluster - 1);
  const int p1 = chain ? 0 : rank * n_proj / (kCluster - 1);

  // the chain's weight stream: layer instance g = t * L + l of the launch
  // lives in stage g % kStages. One thread of the producer warp issues its
  // copies kStages layers ahead and, during layer g, waits for layer g+1's
  // copy to land before it joins the layer's block barrier, so the
  // compute warps never wait on an mbarrier themselves.
  const long long n_inst = (long long)a.T * L;
  const bool producer = chain && tid == 32 * kChainWarps;

  if (chain) {
    if (tid == 0) {
      int o = 0;
      for (int l = 0; l < L; ++l) {
        dil[l] = a.dilations[l];
        off[l] = o;
        o += dil[l];
        slot[l] = (int)(a.t0 % (unsigned long long)dil[l]);
      }
    }
    if (producer) {
      for (int s = 0; s < kStages; ++s)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                         smem_addr(&wbar[s]))
                     : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int g = 0; g < kStages; ++g)
        issue_layer(g, g % L, n_inst, WL, F * K, R * DC, a.wchain, a.wdense,
                    wring, wbar);
      bar_wait(&wbar[0], 0);
    }
    for (int i = tid; i < DC; i += blockDim.x) gated[i] = 0.f;
    for (int i = tid; i < L * F; i += blockDim.x)
      bias[i] = a.bfg[((size_t)(i / F) * a.B + b) * F + i % F];
    for (int i = tid; i < L * R; i += blockDim.x) bd[i] = a.bdense[i];
    __syncthreads();   // dil, off, slot
    prefetch_states(ring, st2, dil, off, slot, L, R, false);
  }
  // every CTA of the cluster runs before any distributed shared access
  cluster_sync();

  // ranks 1-7: lc_t @ W_lc into rank 0's proj[t & 1]
  if (M && !chain) project_lc(lc, a.wlc, lcv, proj0, M, F, p0, p1);
  cluster_sync();

  int code = a.state[2 * b], prev = a.state[2 * b + 1];
  const int* forced = a.forced + (size_t)b * a.prime_len;
  const unsigned long long P = (unsigned long long)a.prime_len;
  int stage = 0;
  uint32_t parity = 0;
  long long inst = 0;   // layer instances done (rank 0)
  int kept_steps = 0;   // the head's steps so far (the gate pushes' phase)
  for (int t = 0; t < a.T; ++t) {
    const unsigned long long abs_ll = a.t0 + (unsigned long long)t;
    const uint32_t abs_t = (uint32_t)abs_ll;
    const bool kept = abs_ll + 1 >= P;
    if (chain) {
      stamp(stamps, t, 0);
      if (abs_ll < P) code = forced[abs_ll];   // priming: the seed is the input
      const float* st = st2 + (t & 1) * L * R;  // prefetched ring states
      for (int i = tid; i < R; i += blockDim.x) {
        float c = wc_cur[code * R + i];
        if (prev >= 0) c = wc_past[prev * R + i] + c;
        cur[i] = c;   // the first layer's input: its "previous" residual
      }
      prev = code;
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
      const float* pj = proj + (t & 1) * n_proj;
      for (int l = 0; l < L; ++l) {
        const bool mid = l == L / 2;
        stamp_clock(stamps, t, 6, mid);
        const float* wf = wring + (size_t)stage * WL;   // [F][K]
        const float* wd = wf + F * K;                   // [R][DC] of layer l-1
        const float* sl = st + l * R;
        const float* cprev = cur + (l & 1) * R4;        // residual of layer l-1
        float* cnew = cur + ((l + 1) & 1) * R4;         // residual of layer l
        const float* gprev = gated + l * DC;            // gates of layer l-1
        if (warp < kGateWarps) {
          // 4 (f, g) pairs per warp over [state | residual | gates] of the
          // layer before: lane = 8 * pair + k-group, each k-group takes
          // every 8th float4 of the K inputs, 3 shuffle rounds sum them
          const int kg = lane & 7;
          for (int p0 = 4 * warp; p0 < DC; p0 += 4 * kGateWarps) {
            const int k = p0 + (lane >> 3);
            const float4* wk = reinterpret_cast<const float4*>(wf) + (size_t)k * K4;
            const float4* gk = wk + (size_t)DC * K4;
            float f = 0.f, g = 0.f;
#pragma unroll
            for (int i4 = kg; i4 < K4; i4 += 8) {
              const int i = 4 * i4;
              const float4 x = *reinterpret_cast<const float4*>(
                  i < R ? sl + i : i < R2 ? cprev + (i - R) : gprev + (i - R2));
              f = dot4(x, wk[i4], f);
              g = dot4(x, gk[i4], g);
            }
#pragma unroll
            for (int o = 1; o < 8; o <<= 1) {
              f += __shfl_xor_sync(0xffffffffu, f, o);
              g += __shfl_xor_sync(0xffffffffu, g, o);
            }
            if (kg == 0) {
              f += bias[l * F + k];
              g += bias[l * F + DC + k];
              if (M) {
                f += pj[l * F + k];
                g += pj[l * F + DC + k];
              }
              gated[(l + 1) * DC + k] = gate_unit(f, g);
            }
          }
          stamp_clock(stamps, t, 8, mid);
        } else if (warp < kChainWarps) {
          // beside the gates: this layer's residual (its ring entry and the
          // next layer's input) from the layer before; 4 outputs per warp,
          // 8 lanes each, every lane 4 consecutive gates at a time
          stamp_clock(stamps_dense, t, 11, mid);
          for (int r0 = 4 * (warp - kGateWarps); r0 < R; r0 += 4 * kDenseWarps) {
            const int r = r0 + (lane >> 3);
            float acc = 0.f;
#pragma unroll
            for (int k4 = lane & 7; k4 < D4; k4 += 8)
              acc = dot4(reinterpret_cast<const float4*>(gprev)[k4],
                         reinterpret_cast<const float4*>(wd + r * DC)[k4], acc);
            acc += __shfl_xor_sync(0xffffffffu, acc, 4);
            acc += __shfl_xor_sync(0xffffffffu, acc, 2);
            acc += __shfl_xor_sync(0xffffffffu, acc, 1);
            if ((lane & 7) == 0) {
              const float c = cprev[r] + (acc + bd[l * R + r]);
              cnew[r] = c;
              ring[(off[l] + slot[l]) * R + r] = c;
            }
          }
          stamp_clock(stamps_dense, t, 10, mid);
        } else if (producer && inst + 1 < n_inst) {
          // the next layer's weights land before this layer's barrier
          const int next = stage + 1 == kStages ? 0 : stage + 1;
          bar_wait(&wbar[next], next == 0 ? parity ^ 1u : parity);
        }
        __syncthreads();
        stamp_clock(stamps, t, 9, mid);
        // this stage is read: the producer refills it kStages layers ahead
        if (producer) {
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          issue_layer(inst + kStages, (l + kStages) % L, n_inst, WL, F * K,
                      R * DC, a.wchain, a.wdense, wring, wbar);
        }
        // and its warp pushes the layer's gates to the head ranks, which
        // sum their skip columns during the chain
        if (kept && warp == kChainWarps) {
          float* row = gated + (l + 1) * DC;
          for (int k4 = lane; k4 < D4; k4 += 32) {
            const float4 v = reinterpret_cast<const float4*>(row)[k4];
            for (int r = 1; r < kCluster; ++r) {
              int g0, g1;
              head_groups(S, r - 1, g0, g1);
              if (g1 > g0) store_remote(row + 4 * k4, v, &gbar[l], r);
            }
          }
        }
        ++inst;
        if (++stage == kStages) {
          stage = 0;
          parity ^= 1u;
        }
      }
      // the next step's ring states (this step's writes are in), during
      // the head
      if (t + 1 < a.T)
        prefetch_states(ring, st2 + ((t + 1) & 1) * L * R, dil, off, slot, L,
                        R, true);
      stamp(stamps, t, 1);
    } else {
      // off the chain: the next step's lc projection, then this step's
      // skip columns from the gates as rank 0 pushes them, all-gathered
      // into the head ranks' vec1
      if (M && t + 1 < a.T)
        project_lc(lc + (size_t)(t + 1) * M, a.wlc, lcv,
                   proj0 + ((t + 1) & 1) * n_proj, M, F, p0, p1);
      if (kept) {
        stamp_clock(stamps_r1, t, 12, true);
        float v = head_segment(hs, 0, gated + DC, part, head_producer, gbar, DC,
                               (uint32_t)kept_steps & 1u);
        if (tid < 4 * (s1 - s0)) {
          const int c = 4 * s0 + tid;
          v = fmaxf(v + a.bskip[c], 0.f);
          for (int r = 1; r < kCluster; ++r) cluster.map_shared_rank(vec1, r)[c] = v;
        }
        stamp_clock(stamps_r1, t, 13, true);
      }
    }
    // A: the chain, the next step's projection and the skip columns are done
    cluster_sync();
    stamp(stamps, t, 2);
    stamp_clock(stamps_r1, t, 14, true);

    if (!kept) {
      // priming step whose code is thrown away: the next input is forced
      if (chain) {
        if (tid == 0) a.codes[(size_t)b * a.T + t] = forced[abs_ll + 1];
        if (tid >= 32 && tid < 32 + L) {
          const int l = tid - 32;
          slot[l] = slot[l] + 1 == dil[l] ? 0 : slot[l] + 1;
        }
        __syncthreads();
      }
      continue;
    }

    // the rest of the head, on ranks 1-7 (rank 0 waits): post1 columns
    // from the gathered skip sum, all-gathered into vec2; then the codes
    // [4*q0, 4*q1) with their noise and a local lowest-index argmax, whose
    // (score, index) goes to rank 0.
    ++kept_steps;
    float v = 0.f;
    if (!chain) {
      v = head_segment(hs, 1, vec1, part, head_producer);
      stamp_clock(stamps_r1, t, 17, true);
      if (tid < 4 * (s1 - s0)) {
        const int c = 4 * s0 + tid;
        v = fmaxf(v + a.b1[c], 0.f);
        for (int r = 1; r < kCluster; ++r) cluster.map_shared_rank(vec2, r)[c] = v;
      }
    }
    cluster_sync();   // B
    stamp(stamps, t, 3);
    stamp_clock(stamps_r1, t, 15, true);
    if (!chain) {
      v = head_segment(hs, 2, vec2, part, head_producer);
      stamp_clock(stamps_r1, t, 16, true);
      float best = __int_as_float(0xff800000);  // -inf
      int best_i = Q;
      if (tid < 4 * (q1 - q0)) {
        const int q = 4 * q0 + tid;
        float sc = v + a.b2[q];
        if (a.inv_temperature > 0.f) {
          const uint32_t bits = philox_word(q >> 2, abs_t, b, 0u, a.seed_lo,
                                            a.seed_hi, q & 3);
          const float u = (float)(bits >> 8) * (1.0f / 16777216.0f) + 1e-10f;
          sc = sc * a.inv_temperature + (-logf(-logf(u)));
        }
        best = sc;
        best_i = q;
      }
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, best, o);
        const int oi = __shfl_down_sync(0xffffffffu, best_i, o);
        if (ov > best || (ov == best && oi < best_i)) {
          best = ov;
          best_i = oi;
        }
      }
      if (lane == 0) {
        red_v[warp] = best;
        red_i[warp] = best_i;
      }
      __syncthreads();
      if (tid == 0) {
        float bv = red_v[0];
        int bi = red_i[0];
        for (int w = 1; w < kWarps; ++w) {
          if (red_v[w] > bv || (red_v[w] == bv && red_i[w] < bi)) {
            bv = red_v[w];
            bi = red_i[w];
          }
        }
        cand_v0[rank] = bv;
        cand_i0[rank] = bi;
      }
    }
    cluster_sync();   // C
    stamp(stamps, t, 4);
    if (chain) {
      if (tid == 0) {   // candidates in rank order: codes in ascending order
        float bv = cand_v[1];
        int bi = cand_i[1];
        for (int r = 2; r < kCluster; ++r) {
          if (cand_v[r] > bv || (cand_v[r] == bv && cand_i[r] < bi)) {
            bv = cand_v[r];
            bi = cand_i[r];
          }
        }
        code_sh = bi;
        a.codes[(size_t)b * a.T + t] = bi;
        stamp(stamps, t, 5);   // the code
      }
      // the ring slots were last read in the layer loop: advance them in
      // warps other than the one finishing the argmax, one thread per layer
      if (tid >= 32 && tid < 32 + L) {
        const int l = tid - 32;
        slot[l] = slot[l] + 1 == dil[l] ? 0 : slot[l] + 1;
      }
      __syncthreads();
      code = code_sh;
    }
  }
  if (chain && tid == 0) {
    a.state[2 * b] = code;
    a.state[2 * b + 1] = prev;
  }
  // the head stream's last refills land before the CTA leaves
  if (head_producer && hs.period)
    for (int i = 0; i < kHeadStages; ++i) {
      const int c = hs.used + i;
      bar_wait(&hbar[c % kHeadStages], (uint32_t)(c / kHeadStages) & 1u);
    }
  // no CTA leaves while another may still touch its shared memory
  cluster_sync();
}

size_t smem_bytes(int L, int R, int DC, int S, int M) {
  return sizeof(float) * (size_t)(4 * kThreads + (L + 1) * DC + 2 * round4(R) +
                                  2 * S + round4(M) + role_floats(L, R, DC, M)) +
         sizeof(uint64_t) * (size_t)L + sizeof(int) * (size_t)(3 * L);
}

using KernelFn = void (*)(const Args);

// The full-width build (R = DC = 32: K / 4 = 24, DC / 4 = 8) or the
// build that reads the widths at run time.
KernelFn pick_kernel(int R, int DC) {
  if (2 * R + DC == 96 && DC == 32) return wavenet_sample_kernel<24, 8>;
  return wavenet_sample_kernel<0, 0>;
}

cudaError_t configure(KernelFn fn, int L, int R, int DC, int S, int M,
                      size_t* smem) {
  *smem = smem_bytes(L, R, DC, S, M);
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

void launch_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int B,
                   size_t smem, cudaStream_t stream) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(kCluster * B, 1, 1);
  cfg->blockDim = dim3(kThreads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

}  // namespace

// Launches the sampler on `stream`, T samples from the carried state
// (rings, state, t0), the inputs of absolute steps < prime_len forced to
// forced[B, prime_len]; returns cudaGetLastError() (0 = ok). `stamps`
// ([64, 6] uint64) is written only by a build with -DWAVENET_STAMPS.
extern "C" int wavenet_sample(
    const float* wc, const float* wchain, const float* wlc, const float* bfg,
    const float* wdense, const float* bdense, const float* head,
    const float* bskip, const float* b1, const float* b2, const int* dilations,
    const float* lc, const int* forced, float* rings, int* state, int* codes,
    unsigned long long* stamps, int B, int T, int L, int R, int DC, int S,
    int Q, int M, int ring_rows, int prime_len, unsigned long long t0,
    float inv_temperature, unsigned long long seed, void* stream) {
  if (L > kThreads - 32 || prime_len < 0 ||
      (prime_len > 0 && forced == nullptr) ||
      (M > 0 && (lc == nullptr || wlc == nullptr)))
    return (int)cudaErrorInvalidValue;
  const KernelFn fn = pick_kernel(R, DC);
  size_t smem;
  cudaError_t err = configure(fn, L, R, DC, S, M, &smem);
  if (err != cudaSuccess) return (int)err;
  Args a{wc,     wchain, wlc,   bfg,   wdense, bdense, head,      bskip,
         b1,     b2,    dilations, lc,  forced,    rings,
         state,  codes,  stamps, B,    T,      L,      R,         DC,
         S,      Q,      M,     ring_rows, prime_len, t0, inv_temperature,
         (uint32_t)(seed & 0xffffffffull), (uint32_t)(seed >> 32)};
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  launch_config(&cfg, &attr, B, smem, (cudaStream_t)stream);
  err = cudaLaunchKernelEx(&cfg, fn, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many 8-CTA clusters of the sampler run at once at these widths
// (cudaOccupancyMaxActiveClusters); a batch with more streams runs in
// waves. Returns a CUDA error code (0 = ok).
extern "C" int wavenet_max_active_clusters(int L, int R, int DC, int S, int M,
                                           int* out) {
  const KernelFn fn = pick_kernel(R, DC);
  size_t smem;
  cudaError_t err = configure(fn, L, R, DC, S, M, &smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  launch_config(&cfg, &attr, 1, smem, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(out, (void*)fn, &cfg);
}

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
// t0 + t < prime_len (a read known when the step starts, off the layer
// chain); launches without priming pass prime_len = 0. A step whose code
// is thrown away (t0 + t < prime_len - 1: its successor's input is forced
// too) runs only the layer stack, which advances the rings, and skips the
// skip sum, the post-net and the argmax (1.21 of the step's ~1.72 M
// multiply-adds at full width); it stores the next forced code instead.
//
// Per sample and per stream: causal one-hot tap -> L gated dilated layers
// (ring read at slot (t0 + t) mod d, fg = [state | current | lc_t] @ W_fg
// + bias, tanh(f)*sigmoid(g), residual update, gated output kept for the
// skip sum) -> skip = gated_all @ W_skip -> ReLU, 1x1, ReLU, 1x1 -> logits ->
// argmax(logits / T + Gumbel) with the lowest-index tie-break; the code is
// the next step's input.
//
// Design: one persistent thread block per stream (blockIdx.x = stream)
// loops over every sample inside the kernel; this replaces the TPU's
// sequential grid over 128-sample chunks. Weights are read from global
// memory: at full width (L=50, R=DC=32, S=512, Q=256, M=80) they are 6.9 MB
// of float32 and stay resident in the 50 MB L2. The dilation rings live in
// a global scratch [B, sum(d), R]; every layer's ring state for a step is
// known when the step starts, so all of them are loaded into shared memory
// at once and only the ring writes stay on the layer chain. Every product
// (the lc projection, the layer matvecs, the skip and post-net products)
// is a block-wide float4 matvec with k-sliced partial sums in shared
// memory; the gate is fused into the dense products, so a layer costs 3
// block barriers and 2 L2 round trips for its weights.
//
// What bounds it: per sample and stream the work is ~3.4 MFLOP over ~6.9 MB
// of weights, so a batch-1 stream is far below the card's roofline; the
// bound is the L2 read rate of the one SM that serves a stream (all 6.9 MB
// of weights every sample, ~60 us at ~64 B per clock) and the dependent
// chain of 50 layers. Later work: weights in the
// distributed shared memory of a cluster, bf16 weights, wgmma across
// streams, lc projected at frame rate.
//
// Noise: Philox4x32-10 keyed by the 64-bit seed; code q of stream b at
// absolute sample t takes word q % 4 of philox(counter = (q / 4, t, b, 0))
// (t taken mod 2^32).
// u = (bits >> 8) * 2^-24 + 1e-10, g = -log(-log(u)). The plain PyTorch
// version (nspeech_tpu_torch/ops/philox.py) computes the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

struct Args {
  const float* wc;       // [2, Q, R]   causal taps: [0] past, [1] current
  const float* wfg;      // [L, K, 2DC] K = 2R + M rows: state | current | lc
  const float* bfg;      // [L, B, 2DC] per-stream bias (biases + gc)
  const float* wdense;   // [L, DC, R]
  const float* bdense;   // [L, R]
  const float* wskip;    // [L*DC, S]
  const float* bskip;    // [S]
  const float* post1;    // [S, S]
  const float* b1;       // [S]
  const float* post2;    // [S, Q]
  const float* b2;       // [Q]
  const int* dilations;  // [L]
  const float* lc;       // [B, T, M] or null when M == 0
  const int* forced;     // [B, prime_len] seed codes or null when prime_len == 0
  float* rings;          // [B, ring_rows, R] carried: read and written in place
  int* state;            // [B, 2] carried (code, prev): read and written
  int* codes;            // [B, T]
  int B, T, L, R, DC, S, Q, M, ring_rows, part_size, prime_len;
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

// Partial sums of y = x[0:K] @ W[K, N] (row-major, N % 4 == 0): thread
// groups of 4 columns times ks k-slices; part[s * N + n] holds slice s.
// Returns ks (the same in every thread). Caller synchronises before
// reading part.
__device__ __forceinline__ int matvec_partial(const float* x,
                                              const float* __restrict__ W,
                                              int K, int N, float* part) {
  const int groups = N >> 2;
  int ks = blockDim.x / groups;
  ks = ks < 1 ? 1 : (ks > K ? K : ks);
  const float4* w4 = reinterpret_cast<const float4*>(W);
  for (int idx = threadIdx.x; idx < groups * ks; idx += blockDim.x) {
    const int g = idx % groups, s = idx / groups;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int k = s; k < K; k += ks) {
      const float xv = x[k];
      const float4 w = __ldg(w4 + (size_t)k * groups + g);
      acc.x = fmaf(xv, w.x, acc.x);
      acc.y = fmaf(xv, w.y, acc.y);
      acc.z = fmaf(xv, w.z, acc.z);
      acc.w = fmaf(xv, w.w, acc.w);
    }
    reinterpret_cast<float4*>(part + (size_t)s * N)[g] = acc;
  }
  return ks;
}

__device__ __forceinline__ float partial_sum(const float* part, int ks, int N,
                                             int n) {
  float v = 0.f;
  for (int s = 0; s < ks; ++s) v += part[s * N + n];
  return v;
}

__device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

__global__ void __launch_bounds__(kThreads)
    wavenet_sample_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, b = blockIdx.x;
  const int R = a.R, DC = a.DC, S = a.S, Q = a.Q, M = a.M, L = a.L;
  const int K = 2 * R + M, F = 2 * DC;

  float* x = smem;                       // [K]: state | current | lc_t
  float* gated = x + round4(K);          // [L * DC] every layer's gate out
  float* vec = gated + L * DC;           // [S]: skip sum, then post1 out
  float* st = vec + S;                   // [L * R] this step's ring states
  float* bias = st + L * R;              // [L * 2DC] this stream's fg bias
  float* bd = bias + L * F;              // [L * R] dense biases
  float* part2 = bd + L * R;             // [DC * R] dense partial products
  float* part = part2 + DC * R;          // matvec partial sums
  int* dil = reinterpret_cast<int*>(part + a.part_size);   // [L]
  int* off = dil + L;                    // [L] ring row offsets
  int* slot = off + L;                   // [L] this step's ring slot
  __shared__ float red_v[kThreads / 32];
  __shared__ int red_i[kThreads / 32];
  __shared__ int code_sh;

  float* ring = a.rings + (size_t)b * a.ring_rows * R;
  const float* lc = M ? a.lc + (size_t)b * a.T * M : nullptr;
  const float* wc_past = a.wc;
  const float* wc_cur = a.wc + (size_t)Q * R;
  const float4* wdense4 = reinterpret_cast<const float4*>(a.wdense);
  const int gR = R >> 2;

  // per-stream constants, loaded once
  if (tid == 0) {
    int o = 0;
    for (int l = 0; l < L; ++l) {
      dil[l] = a.dilations[l];
      off[l] = o;
      o += dil[l];
      slot[l] = (int)(a.t0 % (unsigned long long)dil[l]);
    }
  }
  for (int i = tid; i < L * F; i += blockDim.x)
    bias[i] = a.bfg[((size_t)(i / F) * a.B + b) * F + i % F];
  for (int i = tid; i < L * R; i += blockDim.x) bd[i] = a.bdense[i];
  __syncthreads();

  int code = a.state[2 * b], prev = a.state[2 * b + 1];
  const int* forced = a.forced + (size_t)b * a.prime_len;
  const unsigned long long P = (unsigned long long)a.prime_len;
  for (int t = 0; t < a.T; ++t) {
    const unsigned long long abs_ll = a.t0 + (unsigned long long)t;
    const uint32_t abs_t = (uint32_t)abs_ll;
    if (abs_ll < P) code = forced[abs_ll];   // priming: the seed is the input
    // every layer's ring state for this step, the lc row and the causal tap
    // are known up front: one round of independent loads, off the chain
    for (int i = tid; i < L * R; i += blockDim.x) {
      const int l = i / R;
      st[i] = ring[(off[l] + slot[l]) * R + i % R];
    }
    for (int i = tid; i < M; i += blockDim.x) x[2 * R + i] = lc[(size_t)t * M + i];
    for (int i = tid; i < R; i += blockDim.x) {
      float c = wc_cur[code * R + i];
      if (prev >= 0) c = wc_past[prev * R + i] + c;
      x[R + i] = c;
    }
    prev = code;
    __syncthreads();
    for (int i = tid; i < R; i += blockDim.x) x[i] = st[i];
    __syncthreads();

    for (int l = 0; l < L; ++l) {
      const int ks = matvec_partial(x, a.wfg + (size_t)l * K * F, K, F, part);
      __syncthreads();
      // gate (recomputed by each column group that needs it) fused with
      // the dense products: gated_k * W_dense[k, :]
      for (int idx = tid; idx < gR * DC; idx += blockDim.x) {
        const int g = idx % gR, k = idx / gR;
        const float f = partial_sum(part, ks, F, k) + bias[l * F + k];
        const float gg = partial_sum(part, ks, F, DC + k) + bias[l * F + DC + k];
        const float gv = tanhf(f) * (1.f / (1.f + expf(-gg)));
        if (g == 0) gated[l * DC + k] = gv;
        const float4 w = __ldg(wdense4 + ((size_t)l * DC + k) * gR + g);
        reinterpret_cast<float4*>(part2 + k * R)[g] =
            make_float4(gv * w.x, gv * w.y, gv * w.z, gv * w.w);
      }
      __syncthreads();
      for (int r = tid; r < R; r += blockDim.x) {
        float tr = 0.f;
        for (int k = 0; k < DC; ++k) tr += part2[k * R + r];
        const float cur = x[R + r];
        ring[(off[l] + slot[l]) * R + r] = cur;
        x[R + r] = cur + (tr + bd[l * R + r]);
        if (l + 1 < L) x[r] = st[(l + 1) * R + r];
      }
      __syncthreads();
    }

    if (abs_ll + 1 < P) {
      // priming step whose code is thrown away: the next input is forced
      if (tid == 0) a.codes[(size_t)b * a.T + t] = forced[abs_ll + 1];
      if (tid >= 32 && tid < 32 + L) {
        const int l = tid - 32;
        slot[l] = slot[l] + 1 == dil[l] ? 0 : slot[l] + 1;
      }
      __syncthreads();
      continue;
    }

    // skip sum over every layer's gated output, then the post-net
    int ks = matvec_partial(gated, a.wskip, L * DC, S, part);
    __syncthreads();
    for (int n = tid; n < S; n += blockDim.x)
      vec[n] = fmaxf(partial_sum(part, ks, S, n) + a.bskip[n], 0.f);
    __syncthreads();
    ks = matvec_partial(vec, a.post1, S, S, part);
    __syncthreads();
    for (int n = tid; n < S; n += blockDim.x)
      vec[n] = fmaxf(partial_sum(part, ks, S, n) + a.b1[n], 0.f);
    __syncthreads();
    ks = matvec_partial(vec, a.post2, S, Q, part);
    __syncthreads();

    // scores and the lowest-index argmax
    float best = __int_as_float(0xff800000);  // -inf
    int best_i = Q;
    for (int q = tid; q < Q; q += blockDim.x) {
      float s = partial_sum(part, ks, Q, q) + a.b2[q];
      if (a.inv_temperature > 0.f) {
        const uint32_t bits = philox_word(q >> 2, abs_t, b, 0u, a.seed_lo,
                                          a.seed_hi, q & 3);
        const float u = (float)(bits >> 8) * (1.0f / 16777216.0f) + 1e-10f;
        s = s * a.inv_temperature + (-logf(-logf(u)));
      }
      if (s > best || best_i == Q) {
        best = s;
        best_i = q;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, best, o);
      const int oi = __shfl_down_sync(0xffffffffu, best_i, o);
      if (ov > best || (ov == best && oi < best_i)) {
        best = ov;
        best_i = oi;
      }
    }
    if ((tid & 31) == 0) {
      red_v[tid >> 5] = best;
      red_i[tid >> 5] = best_i;
    }
    __syncthreads();
    if (tid == 0) {
      float bv = red_v[0];
      int bi = red_i[0];
      for (int w = 1; w < (int)(blockDim.x >> 5); ++w) {
        if (red_v[w] > bv || (red_v[w] == bv && red_i[w] < bi)) {
          bv = red_v[w];
          bi = red_i[w];
        }
      }
      code_sh = bi;
      a.codes[(size_t)b * a.T + t] = bi;
    }
    // the ring slots were last read in the layer loop: advance them in
    // warps other than the one finishing the argmax, one thread per layer
    // (L <= kThreads - 32; on an H100 the same update in warp 0 before the
    // barrier above cost 3% of a step, a strided loop here 3% too)
    if (tid >= 32 && tid < 32 + L) {
      const int l = tid - 32;
      slot[l] = slot[l] + 1 == dil[l] ? 0 : slot[l] + 1;
    }
    __syncthreads();
    code = code_sh;
  }
  if (tid == 0) {
    a.state[2 * b] = code;
    a.state[2 * b + 1] = prev;
  }
}

}  // namespace

// Launches the sampler on `stream`, T samples from the carried state
// (rings, state, t0), the inputs of absolute steps < prime_len forced to
// forced[B, prime_len]; returns cudaGetLastError() (0 = ok).
extern "C" int wavenet_sample(
    const float* wc, const float* wfg, const float* bfg, const float* wdense,
    const float* bdense, const float* wskip, const float* bskip,
    const float* post1, const float* b1, const float* post2, const float* b2,
    const int* dilations, const float* lc, const int* forced, float* rings,
    int* state, int* codes, int B, int T, int L, int R, int DC, int S, int Q,
    int M, int ring_rows, int prime_len, unsigned long long t0,
    float inv_temperature, unsigned long long seed, void* stream) {
  if (L > kThreads - 32) return (int)cudaErrorInvalidValue;
  const int K4 = (2 * R + M + 3) & ~3;
  int part = 4 * kThreads;
  if (S > part) part = S;
  if (Q > part) part = Q;
  if (prime_len < 0 || (prime_len > 0 && forced == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{wc,    wfg,   bfg,   wdense, bdense, wskip, bskip, post1,
         b1,    post2, b2,    dilations, lc, forced, rings, state, codes,
         B,     T,     L,     R,      DC,     S,     Q,     M,
         ring_rows, part, prime_len, t0, inv_temperature,
         (uint32_t)(seed & 0xffffffffull), (uint32_t)(seed >> 32)};
  const size_t smem =
      sizeof(float) * (size_t)(K4 + L * DC + S + L * R + 2 * L * DC + L * R +
                               DC * R + part) +
      sizeof(int) * (size_t)(3 * L);
  cudaError_t err = cudaFuncSetAttribute(
      wavenet_sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  wavenet_sample_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

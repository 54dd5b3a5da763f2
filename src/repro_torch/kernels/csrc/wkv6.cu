// RWKV6 WKV recurrence, output only, for Hopper (sm_90a).  Two variants of
// one function.
//
// Replaces: src/repro/kernels/wkv6.py::wkv6 (_wkv6_kernel, :50), the Pallas
// TPU kernel reached from models/ssm.py::rwkv6_time_mix through
// kernels/ops.py::routed_wkv6.  Per (batch b, head h), with a K x K f32
// state S that starts at zero:
//   o_t = r_t . (S + diag(u) k_t v_t^T)
//   S   <- diag(exp(lw_t)) S + k_t v_t^T
// r, k, v, u in one type (f32 or bf16), lw in f32 (the model computes the
// decay in f32), o in r's type; the final state is not returned.
//
// What bounds it: the bytes.  At the main path's shape (rwkv6-7b: B = 2,
// T = 4096, H = 64, K = 64; bf16 r/k/v/u, f32 lw) the inputs and the
// output are 402.7 MB, 0.1202 ms at 3.35 TB/s.  The chunked form below
// does about 1.4e10 FLOP on the tensor cores (0.014 ms at 989 TFLOP/s
// bf16), the sequential form 1.1e10 f32 FLOP (0.16 ms at 67 TFLOP/s).
// Neither sets the time unless the serial chain over T does.
//
// The chunked variant (bf16 r/k/v/u, K in {16, 32, 64}, 16-byte-aligned
// pointers; ops.wkv6_route picks it): the chunked form of
// src/repro/models/ssm.py::wkv6_chunked, in 16-step chunks.  Within a
// chunk, with L the inclusive cumulative sum of lw from the chunk's start,
// Lq its exclusive one and c = L[8] (the midpoint):
//   r~ = r exp(Lq - c), k~ = k exp(c - L)        (so r~_t k~_s = r k e^{Lq_t - L_s})
//   A[t][s] = r~_t . k~_s for s < t, u-diagonal sum_i r u k for s = t, else 0
//   o = A v + (r exp(Lq)) S_0                    (S_0: the state at the chunk's start)
//   S_16 = diag(exp(L[15])) S_0 + (k exp(L[15] - L))^T v
// Only S's carry from chunk to chunk is serial: one elementwise scale and
// one MMA per chunk.
//   * Filling the card: one CTA per (b, h), 128 CTAs on the main path, one
//     per SM.  Its K/16 consumer warps each own 16 of S's columns (o[:, j]
//     reads only S[:, j]) as f32 MMA accumulators, 32 registers at K = 64,
//     and walk the chunks in order.  Eight producer warps (four at K = 16)
//     make the next chunk's factors meanwhile (a channel pair and two
//     steps per thread at K = 64), so one chunk's factors overlap the last
//     one's products;
//     one __syncthreads per chunk hands them over.  Splitting a (b, h)'s
//     columns over CTAs instead would re-read r, k and lw once per slice and
//     repeat the factor work; here every input byte is read from memory
//     once and the factors are made once, in shared memory, for every
//     consumer warp.  What holds a chunk back is latency inside the SM, not
//     bytes: the producers' and the consumers' work per chunk are each about
//     as long as the chunk's loads (PERF.md has the split).
//   * Tensor cores: the four products per chunk (scores r~ k~^T, A v, the
//     cross term r S_0 and the state's increment) are mma.sync m16n8k16
//     bf16 -> f32, 58 per warp per chunk at K = 64.  Each consumer warp
//     keeps S transposed (S^T: 16 columns x K rows), so its accumulator
//     fragments, packed to bf16 pairs, are the A operand of S^T r^T as
//     they stand, and the score fragments, masked and packed, are the B
//     operand of V^T A^T.  wgmma's 64-row minimum would need 64-step
//     chunks, which the midpoint factorisation cannot hold at the decay
//     clamp (the masked pairs reach e^{3.5 * 63}), so mma.sync it is.
//   * Streaming: a 5-stage ring of chunks in shared memory, four chunks
//     ahead.  One producer thread issues a chunk as four TMA boxes (r, k, v
//     and lw: K x 1 x 16 x 1 of a (K, H, T, B) tensor map each), completing
//     on the stage's mbarrier, which every thread waits on before it reads
//     the stage.  (16-byte cp.async copies, 640 per chunk, kept the
//     load/store pipe too busy; one bulk copy per row was slower still.)
//   * Numerics: lw is clipped to [-3.5, -1e-6], as wkv6_chunked clips it;
//     inside the model's contract (its own clamp, ssm.py _LOG_DECAY_MIN)
//     the clip changes nothing, outside it no input gives inf or NaN.  The
//     cumulative sums and exps are f32.  At the clamp every factor is
//     finite: r~ <= e^31.5 |r|, k~ <= e^24.5 |k|, the masked score sums
//     <= e^56 |r||k| K in the f32 accumulator, and the masked upper
//     triangle is removed by selection, never multiplied by 0.  r~, k~,
//     r exp(Lq) and S^T enter their products as a bf16 pair, hi + lo
//     (three MMAs: hi hi + hi lo + lo hi, about 16 bits of mantissa): one
//     bf16 rounding of them loses the rows whose sum cancels, at the
//     clamp most of all (tests/test_torch_wkv6_route.py holds this
//     kernel's arithmetic against the per-row gate both ways).  bf16
//     rounding enters once at k exp(L[15] - L) (the state's increment), at
//     A (the scores and the u-diagonal) before the product with v, and at
//     the output; S itself stays f32, and v is bf16 already.
//   * Any T: rows past T fall outside the tensor maps and arrive as zeros
//     (r = k = v = 0), their lw is taken as 0 (not clipped); no output is
//     written past T.
//   * The same bits every run and for every B: no atomics; every sum has a
//     fixed order and one owner; a (b, h) reads nothing of another.
//
// The serial variant (f32, K = 8, and bf16 the chunked variant does not
// take): kept from the first port.  As in the original RWKV CUDA kernel,
// one CTA of K threads owns one (b, h) and runs the whole time loop;
// thread j holds column j of S in registers.  It stages 32 steps of r, k,
// exp(lw) and v in shared memory with one round of independent loads, then
// runs them from shared memory with no barrier between steps; its time is
// T times the latency of one step (1.8 ms at the main path's shape on an
// NVIDIA H100 80GB HBM3, 700.00 W).  It does not clip lw.
//
// The wrapper (kernels/ops.py) allocates o; the C entry points launch on
// the caller's stream and return cudaGetLastError() (or
// cudaErrorInvalidValue for arguments a kernel does not take, and 1000 +
// the CUresult when a tensor map cannot be encoded).  The chunked
// variant's tensor maps are encoded on the host at every call and passed
// by value as a __grid_constant__ parameter, which CUDA-graph capture
// records by value; cuTensorMapEncodeTiled comes through
// cudaGetDriverEntryPoint, so the library needs no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

// ---------------------------------------------------------------------------
// The serial variant.
// ---------------------------------------------------------------------------

constexpr int kChunk = 32;   // time steps staged in shared memory at once

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// r, k, v, lw, o: contiguous (B, n_t, n_h, K); u: contiguous (n_h, K).
// Grid: B * n_h CTAs of K threads.
template <typename T, int K>
__global__ void __launch_bounds__(K)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ lw,
            const T* __restrict__ u, T* __restrict__ o, int n_t, int n_h) {
  __shared__ float rs[kChunk][K];
  __shared__ float ks[kChunk][K];
  __shared__ float ws[kChunk][K];
  __shared__ float vs[kChunk][K];
  __shared__ float us[K];
  const int b = blockIdx.x / n_h;
  const int h = blockIdx.x % n_h;
  const int j = threadIdx.x;
  const size_t step = static_cast<size_t>(n_h) * K;        // one time step
  const size_t base = (static_cast<size_t>(b) * n_t * n_h + h) * K + j;
  us[j] = to_f32(u[h * K + j]);

  float state[K];                 // column j of S: state[i] = S[i][j]
#pragma unroll
  for (int i = 0; i < K; ++i) state[i] = 0.0f;

  for (int t0 = 0; t0 < n_t; t0 += kChunk) {
    const int steps = min(kChunk, n_t - t0);
    __syncthreads();              // the previous chunk has been consumed
#pragma unroll 8
    for (int s = 0; s < steps; ++s) {
      const size_t e = base + static_cast<size_t>(t0 + s) * step;
      rs[s][j] = to_f32(r[e]);
      ks[s][j] = to_f32(k[e]);
      ws[s][j] = expf(lw[e]);
      vs[s][j] = to_f32(v[e]);
    }
    __syncthreads();
    for (int s = 0; s < steps; ++s) {
      const float vj = vs[s][j];
      float acc0 = 0.0f;
      float acc1 = 0.0f;
#pragma unroll
      for (int i = 0; i < K; i += 2) {
        const float kv0 = ks[s][i] * vj;
        const float kv1 = ks[s][i + 1] * vj;
        acc0 = fmaf(rs[s][i], fmaf(us[i], kv0, state[i]), acc0);
        acc1 = fmaf(rs[s][i + 1], fmaf(us[i + 1], kv1, state[i + 1]), acc1);
        state[i] = fmaf(ws[s][i], state[i], kv0);
        state[i + 1] = fmaf(ws[s][i + 1], state[i + 1], kv1);
      }
      o[base + static_cast<size_t>(t0 + s) * step] = from_f32<T>(acc0 + acc1);
    }
  }
}

template <typename T, int K>
int launch_k(const void* r, const void* k, const void* v, const void* lw,
             const void* u, void* o, int n_b, int n_t, int n_h,
             cudaStream_t stream) {
  wkv6_kernel<T, K><<<n_b * n_h, K, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(lw),
      static_cast<const T*>(u), static_cast<T*>(o), n_t, n_h);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_wkv6(const void* r, const void* k, const void* v, const void* lw,
                const void* u, void* o, int n_b, int n_t, int n_h, int n_k,
                cudaStream_t stream) {
  if (n_b < 1 || n_t < 1 || n_h < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (n_k) {
    case 8:
      return launch_k<T, 8>(r, k, v, lw, u, o, n_b, n_t, n_h, stream);
    case 16:
      return launch_k<T, 16>(r, k, v, lw, u, o, n_b, n_t, n_h, stream);
    case 32:
      return launch_k<T, 32>(r, k, v, lw, u, o, n_b, n_t, n_h, stream);
    case 64:
      return launch_k<T, 64>(r, k, v, lw, u, o, n_b, n_t, n_h, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// The chunked variant.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kC = 16;            // steps per chunk (the reference's _RWKV_CHUNK)
constexpr int kStages = 5;        // chunks in the TMA ring
constexpr float kLogDecayMin = -3.5f;
constexpr float kLogDecayMax = -1e-6f;

// Shared memory of one CTA, in bytes.  Rows of bf16 [kC][K] arrays are
// padded to K + 8 elements and k_st^T's rows to kC + 8, so the fragment
// loads (8 rows x 4 words per instruction) hit 32 distinct banks.
template <int K>
struct Layout {
  static constexpr int kRow = K + 8;
  static constexpr int kKst = kC + 8;
  static constexpr int kOutRow = 24;               // staged output row
  static constexpr int kConsumers = K / 16;        // warps
  // producer threads: one per channel pair and step group (two steps at
  // K = 64, one at K <= 32)
  static constexpr int kProducers = K >= 32 ? 256 : 128;
  static constexpr int kThreads = 32 * kConsumers + kProducers;
  static constexpr int kTile = kC * kRow * 2;      // one padded bf16 tile
  // ring stage: r, k, v as dense [kC][K] bf16 TMA boxes, then lw [kC][K] f32
  static constexpr int kBox = kC * K * 2;
  static constexpr int kStage = 3 * kBox + kC * K * 4;
  // factors: r~, k~, r exp(Lq) as hi and lo tiles, k_st^T [K][kKst] bf16,
  // diag [kC] f32, dec [K] f32
  static constexpr int kFactors = 6 * kTile + K * kKst * 2 + kC * 4 + K * 4;
  static constexpr int kScratch = kC * K * 4;      // producers' r u k
  static constexpr int kTotals = kProducers * 8;   // a float2 per producer
  static constexpr int kOut = kC * kOutRow * 2;    // per consumer warp
  static constexpr int kRing = 0;
  static constexpr int kFactorBase = kStages * kStage;
  static constexpr int kScratchBase = kFactorBase + 2 * kFactors;
  static constexpr int kTotalsBase = kScratchBase + kScratch;
  static constexpr int kOutBase = kTotalsBase + kTotals;
  static constexpr int kBarBase = kOutBase + kConsumers * kOut;  // mbarriers
  static constexpr int kBytes = kBarBase + kStages * 8;
  static_assert(kStage % 128 == 0 && kBox % 128 == 0,
                "TMA boxes land 128-byte aligned");
  static_assert(kFactors % 16 == 0 && kTile % 16 == 0,
                "16-byte alignment of every region");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// Named barrier 1: the producer warps only (0 is __syncthreads).
template <int K>
__device__ __forceinline__ void producers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(Layout<K>::kProducers) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// x, y as bf16 pairs: hi = bf16(x, y), lo = bf16(x - hi, y - hi).
__device__ __forceinline__ void split_pack(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}
__device__ __forceinline__ void split_store2(bf16* hi, bf16* lo, float x,
                                             float y) {
  uint32_t h, l;
  split_pack(x, y, h, l);
  *reinterpret_cast<uint32_t*>(hi) = h;
  *reinterpret_cast<uint32_t*>(lo) = l;
}

// d += a b: m16n8k16, a row-major (4 regs), b column-major (2 regs), f32.
// Not volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A product of split operands, a_hi b_hi + a_hi b_lo + a_lo b_hi, in three
// accumulators, so the three MMAs of a step do not wait on each other.
struct Acc3 {
  float hh[4] = {};
  float hl[4] = {};
  float lh[4] = {};
  __device__ float sum(int e) const { return hh[e] + (hl[e] + lh[e]); }
};
__device__ __forceinline__ void mma3(Acc3& d, const uint32_t (&a_hi)[4],
                                     const uint32_t (&a_lo)[4],
                                     const bf16* b_hi, const bf16* b_lo) {
  const uint32_t h0 = ld32(b_hi), h1 = ld32(b_hi + 8);
  mma(d.hh, a_hi, h0, h1);
  mma(d.hl, a_hi, ld32(b_lo), ld32(b_lo + 8));
  mma(d.lh, a_lo, h0, h1);
}

template <int K>
struct Factors {            // views into one factor buffer
  bf16* rt[2];              // [kC][kRow]  r exp(Lq - c), hi and lo
  bf16* kt[2];              // [kC][kRow]  k exp(c - L), hi and lo
  bf16* rc[2];              // [kC][kRow]  r exp(Lq), hi and lo
  bf16* kst;                // [K][kKst]   (k exp(L[15] - L))^T
  float* diag;              // [kC]        sum_i r u k
  float* dec;               // [K]         exp(L[15])
  __device__ explicit Factors(unsigned char* base) {
    using Ly = Layout<K>;
    for (int e = 0; e < 2; ++e) {
      rt[e] = reinterpret_cast<bf16*>(base + e * Ly::kTile);
      kt[e] = reinterpret_cast<bf16*>(base + (2 + e) * Ly::kTile);
      rc[e] = reinterpret_cast<bf16*>(base + (4 + e) * Ly::kTile);
    }
    kst = reinterpret_cast<bf16*>(base + 6 * Ly::kTile);
    diag = reinterpret_cast<float*>(base + 6 * Ly::kTile +
                                    K * Ly::kKst * 2);
    dec = diag + kC;
  }
};

// The four (K, H, T, B) tensor maps of r, k, v and lw; a box is one
// chunk of one (b, h): K x 1 x kC x 1.
struct Maps {
  CUtensorMap r, k, v, lw;
};

// One producer thread: copy chunk `c` (if it exists) into its ring stage,
// one TMA box per tensor, completing on the stage's mbarrier.  Rows past T
// fall outside the maps and arrive as zeros.
template <int K>
__device__ __forceinline__ void issue_chunk(unsigned char* ring,
                                            uint32_t bars, const Maps& maps,
                                            int c, int n_c, int b, int h) {
  using Ly = Layout<K>;
  if (c >= n_c) return;
  unsigned char* stage = ring + (c % kStages) * Ly::kStage;
  const uint32_t bar = bars + (c % kStages) * 8;
  mbar_expect_tx(bar, Ly::kStage);
  tma_load(stage, &maps.r, bar, 0, h, c * kC, b);
  tma_load(stage + Ly::kBox, &maps.k, bar, 0, h, c * kC, b);
  tma_load(stage + 2 * Ly::kBox, &maps.v, bar, 0, h, c * kC, b);
  tma_load(stage + 3 * Ly::kBox, &maps.lw, bar, 0, h, c * kC, b);
}

// Producers: the factors of chunk `c` from its ring stage.  Thread p owns
// the channel pair (i, i + 1), i = 2 (p % (K / 2)), and steps [grp kSteps,
// (grp + 1) kSteps), so its loads, conversions and stores go in pairs.  The
// cumulative sums L: each thread sums its own steps, the step groups'
// totals meet in shared memory, and every thread runs the same chain over
// them (so L[8] and L[15] have the same bits in every thread of a channel).
template <int K>
__device__ __forceinline__ void make_factors(const unsigned char* stage,
                                             Factors<K> f, float* scratch,
                                             float2* totals, int c, int n_t,
                                             int p, float2 u2) {
  using Ly = Layout<K>;
  constexpr int kGroups = Ly::kProducers / (K / 2);
  constexpr int kSteps = kC / kGroups;
  constexpr int kMidGroup = (kC / 2) / kSteps;   // L[8] opens this group
  const int pair = p % (K / 2);
  const int i = 2 * pair;
  const int grp = p / (K / 2);
  const int t0 = grp * kSteps;
  const int valid = n_t - c * kC;             // steps of this chunk before T
  const bf16* rs = reinterpret_cast<const bf16*>(stage);
  const bf16* ks = reinterpret_cast<const bf16*>(stage + Ly::kBox);
  const float* lws = reinterpret_cast<const float*>(stage + 3 * Ly::kBox);
  auto clipped = [&](int t) {                 // lw, clipped; 0 past T
    const float2 x = *reinterpret_cast<const float2*>(lws + t * K + i);
    const bool pad = t >= valid;
    return make_float2(
        pad ? 0.0f : fminf(fmaxf(x.x, kLogDecayMin), kLogDecayMax),
        pad ? 0.0f : fminf(fmaxf(x.y, kLogDecayMin), kLogDecayMax));
  };
  float lt[2][kSteps], lq[2][kSteps];         // L and L_{t-1} of my steps
  float2 acc = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const float2 x = clipped(t0 + s);
    acc.x += x.x;
    acc.y += x.y;
    lt[0][s] = acc.x;
    lt[1][s] = acc.y;
  }
  totals[grp * (K / 2) + pair] = acc;
  producers_sync<K>();
  float2 run = make_float2(0.0f, 0.0f);       // L before group g
  float2 before = run, mid_base = run;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    if (g == grp) before = run;
    if (g == kMidGroup) mid_base = run;
    const float2 tot = totals[g * (K / 2) + pair];
    run.x += tot.x;
    run.y += tot.y;
  }
  const float2 x8 = clipped(kC / 2);
  const float mid[2] = {mid_base.x + x8.x, mid_base.y + x8.y};
  const float last[2] = {run.x, run.y};
  const float pre[2] = {before.x, before.y};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int s = kSteps - 1; s >= 0; --s) {
      lt[h][s] = pre[h] + lt[h][s];   // at step 8: mid's sum, bit for bit
      lq[h][s] = s == 0 ? pre[h] : pre[h] + lt[h][s - 1];
    }
  }
  float e_mid[2], e_tail[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    e_mid[h] = __expf(mid[h]);
    e_tail[h] = __expf(last[h] - mid[h]);
  }
  if (grp == 0) {
    *reinterpret_cast<float2*>(f.dec + i) =
        make_float2(__expf(last[0]), __expf(last[1]));
  }
  float kst[2][kSteps];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int t = t0 + s;
    const int e = t * Ly::kRow + i;
    const float2 rv = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(rs + t * K + i));
    const float2 kv = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(ks + t * K + i));
    const float rt0 = rv.x * __expf(lq[0][s] - mid[0]);
    const float rt1 = rv.y * __expf(lq[1][s] - mid[1]);
    const float kt0 = kv.x * __expf(mid[0] - lt[0][s]);
    const float kt1 = kv.y * __expf(mid[1] - lt[1][s]);
    split_store2(f.rt[0] + e, f.rt[1] + e, rt0, rt1);
    split_store2(f.kt[0] + e, f.kt[1] + e, kt0, kt1);
    split_store2(f.rc[0] + e, f.rc[1] + e, rt0 * e_mid[0], rt1 * e_mid[1]);
    kst[0][s] = kt0 * e_tail[0];
    kst[1][s] = kt1 * e_tail[1];
    *reinterpret_cast<float2*>(scratch + t * K + i) =
        make_float2(rv.x * u2.x * kv.x, rv.y * u2.y * kv.y);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    bf16* row = f.kst + (i + h) * Ly::kKst + t0;
    if constexpr (kSteps % 2 == 0) {
#pragma unroll
      for (int s = 0; s < kSteps; s += 2) {
        *reinterpret_cast<uint32_t*>(row + s) =
            pack_bf16(kst[h][s], kst[h][s + 1]);
      }
    } else {
#pragma unroll
      for (int s = 0; s < kSteps; ++s) row[s] = __float2bfloat16(kst[h][s]);
    }
  }
  producers_sync<K>();
  // the u-diagonal: kSegs threads share a step, each summing K / kSegs
  // channels, then combine by a fixed butterfly
  constexpr int kSegs = Ly::kProducers / kC;
  constexpr int kSeg = K / kSegs;
  const int t = p / kSegs;
  const int seg = p % kSegs;
  float d = 0.0f;
#pragma unroll
  for (int e = 0; e < kSeg; ++e) d += scratch[t * K + seg * kSeg + e];
#pragma unroll
  for (int m = 1; m < kSegs; m *= 2) d += __shfl_xor_sync(0xffffffffu, d, m);
  if (seg == 0) f.diag[t] = d;
}

// Consumer warp w: chunk `c`'s output columns [16 w, 16 w + 16) and the
// carry of S^T's rows [16 w, 16 w + 16).  st[n][.] is S^T's accumulator
// fragment n (columns i in [8 n, 8 n + 8)): st[n][0] = S^T[g][8n + 2q],
// [1] = S^T[g][8n + 2q + 1], [2] and [3] the same for row g + 8.
template <int K>
__device__ __forceinline__ void consume_chunk(
    const unsigned char* stage, Factors<K> f, float (&st)[K / 8][4],
    bf16* out_stage, bf16* o, int c, int b, int h, int n_t, int n_h, int w,
    int lane) {
  using Ly = Layout<K>;
  constexpr int kRow = Ly::kRow;
  const int g = lane / 4;
  const int q = lane % 4;
  const int j0 = 16 * w;
  // scores P = r~ k~^T (rows t, columns s): P[n] covers s in [8n, 8n + 8)
  Acc3 sc[2];
#pragma unroll
  for (int kt = 0; kt < K / 16; ++kt) {
    const int col = 16 * kt + 2 * q;
    uint32_t a[2][4];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      a[e][0] = ld32(f.rt[e] + g * kRow + col);
      a[e][1] = ld32(f.rt[e] + (g + 8) * kRow + col);
      a[e][2] = ld32(f.rt[e] + g * kRow + col + 8);
      a[e][3] = ld32(f.rt[e] + (g + 8) * kRow + col + 8);
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int at = (8 * n + g) * kRow + col;
      mma3(sc[n], a[0], a[1], f.kt[0] + at, f.kt[1] + at);
    }
  }
  // A = the strictly lower triangle of P, the u-diagonal on the diagonal,
  // 0 above it: chosen, not multiplied
  const float d_lo = f.diag[g];
  const float d_hi = f.diag[g + 8];
  float a_val[2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = g + 8 * (e / 2);
      const int s = 8 * n + 2 * q + (e % 2);
      a_val[n][e] =
          s < t ? sc[n].sum(e) : (s == t ? (e < 2 ? d_lo : d_hi) : 0.0f);
    }
  }
  // B fragments of A^T (rows s, columns t) for the two 8-step t tiles
  const uint32_t at[2][2] = {
      {pack_bf16(a_val[0][0], a_val[0][1]), pack_bf16(a_val[1][0], a_val[1][1])},
      {pack_bf16(a_val[0][2], a_val[0][3]), pack_bf16(a_val[1][2], a_val[1][3])}};
  // o^T = S_0^T (r exp(Lq))^T + V^T A^T, rows j (16), columns t (16)
  Acc3 cross[2];
#pragma unroll
  for (int kt = 0; kt < K / 16; ++kt) {
    uint32_t hi[4], lo[4];
    split_pack(st[2 * kt][0], st[2 * kt][1], hi[0], lo[0]);
    split_pack(st[2 * kt][2], st[2 * kt][3], hi[1], lo[1]);
    split_pack(st[2 * kt + 1][0], st[2 * kt + 1][1], hi[2], lo[2]);
    split_pack(st[2 * kt + 1][2], st[2 * kt + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int at = (8 * n + g) * kRow + 16 * kt + 2 * q;
      mma3(cross[n], hi, lo, f.rc[0] + at, f.rc[1] + at);
    }
  }
  float acc[2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = cross[n].sum(e);
  }
  const bf16* vs = reinterpret_cast<const bf16*>(stage + 2 * Ly::kBox);
  const int s0 = 2 * q;
  const uint32_t av[4] = {
      pack_raw(vs[s0 * K + j0 + g], vs[(s0 + 1) * K + j0 + g]),
      pack_raw(vs[s0 * K + j0 + g + 8], vs[(s0 + 1) * K + j0 + g + 8]),
      pack_raw(vs[(s0 + 8) * K + j0 + g], vs[(s0 + 9) * K + j0 + g]),
      pack_raw(vs[(s0 + 8) * K + j0 + g + 8], vs[(s0 + 9) * K + j0 + g + 8])};
#pragma unroll
  for (int n = 0; n < 2; ++n) mma(acc[n], av, at[n][0], at[n][1]);
  // S^T <- S^T diag(exp(L[15])) + V^T k_st
#pragma unroll
  for (int n = 0; n < K / 8; ++n) {
    const float d0 = f.dec[8 * n + 2 * q];
    const float d1 = f.dec[8 * n + 2 * q + 1];
    st[n][0] *= d0;
    st[n][1] *= d1;
    st[n][2] *= d0;
    st[n][3] *= d1;
    const bf16* kr = f.kst + (8 * n + g) * Ly::kKst + 2 * q;
    mma(st[n], av, ld32(kr), ld32(kr + 8));
  }
  // stage o^T's fragments as rows t of 16 columns, then one 16-byte store
  // per lane: row lane / 2, half lane % 2
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int t = 8 * n + 2 * q;
    out_stage[t * Ly::kOutRow + g] = __float2bfloat16(acc[n][0]);
    out_stage[(t + 1) * Ly::kOutRow + g] = __float2bfloat16(acc[n][1]);
    out_stage[t * Ly::kOutRow + g + 8] = __float2bfloat16(acc[n][2]);
    out_stage[(t + 1) * Ly::kOutRow + g + 8] = __float2bfloat16(acc[n][3]);
  }
  __syncwarp();
  const int t = lane / 2;
  const int half = lane % 2;
  if (c * kC + t < n_t) {
    const size_t row = (static_cast<size_t>(b) * n_t + c * kC + t) * n_h + h;
    *reinterpret_cast<uint4*>(o + row * K + j0 + 8 * half) =
        *reinterpret_cast<const uint4*>(out_stage + t * Ly::kOutRow + 8 * half);
  }
  __syncwarp();
}

// r, k, v, lw, o: contiguous (B, n_t, n_h, K); u: contiguous (n_h, K).
// Grid: B * n_h CTAs of Layout<K>::kThreads threads: K / 16 consumer warps,
// then four producer warps.
template <int K>
__global__ void __launch_bounds__(Layout<K>::kThreads)
wkv6_chunked_kernel(const __grid_constant__ Maps maps,
                    const bf16* __restrict__ u, bf16* __restrict__ o,
                    int n_t, int n_h) {
  using Ly = Layout<K>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.x / n_h;
  const int h = blockIdx.x % n_h;
  const int n_c = (n_t + kC - 1) / kC;
  const int w = threadIdx.x / 32;
  const bool producer = w >= Ly::kConsumers;
  unsigned char* ring = smem + Ly::kRing;
  float* scratch = reinterpret_cast<float*>(smem + Ly::kScratchBase);
  float2* totals = reinterpret_cast<float2*>(smem + Ly::kTotalsBase);
  unsigned char* factor_base = smem + Ly::kFactorBase;   // two buffers

  float st[K / 8][4];
#pragma unroll
  for (int n = 0; n < K / 8; ++n) {
    st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.0f;
  }
  const int p = threadIdx.x - 32 * Ly::kConsumers;
  const uint32_t bars = smem_u32(smem + Ly::kBarBase);
  auto ready = [bars](int c) {                // chunk c is in its stage
    mbar_wait(bars + (c % kStages) * 8, (c / kStages) & 1);
  };
  if (threadIdx.x == 0) {
    for (int e = 0; e < kStages; ++e) mbar_init(bars + e * 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  float2 u2 = make_float2(0.0f, 0.0f);
  if (producer) {
    u2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
        u + h * K + 2 * (p % (K / 2))));
    if (p == 0) {
      for (int c = 0; c < kStages - 1; ++c) {
        issue_chunk<K>(ring, bars, maps, c, n_c, b, h);
      }
    }
    ready(0);
    make_factors<K>(ring, Factors<K>(factor_base), scratch, totals, 0, n_t,
                    p, u2);
  }
  __syncthreads();
  bf16* out_stage = reinterpret_cast<bf16*>(smem + Ly::kOutBase) +
                    (producer ? 0 : w * kC * Ly::kOutRow);
  // Iteration c: the consumers take chunk c, the producers make chunk c + 1's
  // factors and copy chunk c + kStages - 1 into the stage chunk c - 1 left.
  for (int c = 0; c < n_c; ++c) {
    if (producer) {
      if (p == 0) {
        issue_chunk<K>(ring, bars, maps, c + kStages - 1, n_c, b, h);
      }
      if (c + 1 < n_c) {
        ready(c + 1);
        make_factors<K>(ring + ((c + 1) % kStages) * Ly::kStage,
                        Factors<K>(factor_base + ((c + 1) & 1) * Ly::kFactors),
                        scratch, totals, c + 1, n_t, p, u2);
      }
    } else {
      ready(c);
      consume_chunk<K>(ring + (c % kStages) * Ly::kStage,
                       Factors<K>(factor_base + (c & 1) * Ly::kFactors), st,
                       out_stage, o, c, b, h, n_t, n_h, w, threadIdx.x % 32);
    }
    __syncthreads();
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// The (K, H, T, B) tensor map of a contiguous (B, T, H, K) tensor with
// `size`-byte elements, boxes of K x 1 x kC x 1, zeros out of bounds.
// Returns 0, or 1000 + the CUresult.
int encode(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
           int size, int n_b, int n_t, int n_h, int n_k) {
  const EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(n_k),
                              static_cast<cuuint64_t>(n_h),
                              static_cast<cuuint64_t>(n_t),
                              static_cast<cuuint64_t>(n_b)};
  const cuuint64_t row = static_cast<cuuint64_t>(n_k) * size;
  const cuuint64_t bytes[3] = {row, row * n_h, row * n_h * n_t};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(n_k), 1, kC, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res =
      fn(map, type, 4, const_cast<void*>(ptr), dims, bytes, box, unit,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : 1000 + static_cast<int>(res);
}

template <int K>
int launch_chunked_k(const void* r, const void* k, const void* v,
                     const void* lw, const void* u, void* o, int n_b, int n_t,
                     int n_h, cudaStream_t stream) {
  using Ly = Layout<K>;
  Maps maps;
  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  int err = encode(&maps.r, r, bf, 2, n_b, n_t, n_h, K);
  if (err == 0) err = encode(&maps.k, k, bf, 2, n_b, n_t, n_h, K);
  if (err == 0) err = encode(&maps.v, v, bf, 2, n_b, n_t, n_h, K);
  if (err == 0) {
    err = encode(&maps.lw, lw, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, n_b, n_t,
                 n_h, K);
  }
  if (err != 0) return err;
  static bool smem_set = false;      // once per K, before any capture
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        wkv6_chunked_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Ly::kBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  wkv6_chunked_kernel<K><<<n_b * n_h, Ly::kThreads, Ly::kBytes, stream>>>(
      maps, static_cast<const bf16*>(u), static_cast<bf16*>(o), n_t, n_h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The serial variant.  r, k, v, lw, o: contiguous (n_b, n_t, n_h, n_k)
// with r/k/v/o f32 and lw f32; u: contiguous (n_h, n_k) f32.
// n_k in {8, 16, 32, 64}.
int wkv6_serial_f32(const void* r, const void* k, const void* v,
                    const void* lw, const void* u, void* o, int n_b, int n_t,
                    int n_h, int n_k, void* stream) {
  return launch_wkv6<float>(r, k, v, lw, u, o, n_b, n_t, n_h, n_k,
                            static_cast<cudaStream_t>(stream));
}

// The same with r, k, v, u and o in bf16; lw stays f32, the state f32.
int wkv6_serial_bf16(const void* r, const void* k, const void* v,
                     const void* lw, const void* u, void* o, int n_b, int n_t,
                     int n_h, int n_k, void* stream) {
  return launch_wkv6<__nv_bfloat16>(r, k, v, lw, u, o, n_b, n_t, n_h, n_k,
                                    static_cast<cudaStream_t>(stream));
}

// The chunked variant: r, k, v, u and o in bf16, lw f32, every pointer
// 16-byte aligned; n_k in {16, 32, 64}.
int wkv6_chunked_bf16(const void* r, const void* k, const void* v,
                      const void* lw, const void* u, void* o, int n_b,
                      int n_t, int n_h, int n_k, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto misaligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if (n_b < 1 || n_t < 1 || n_h < 1 || misaligned(r) || misaligned(k) ||
      misaligned(v) || misaligned(lw) || misaligned(u) || misaligned(o)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (n_k) {
    case 16:
      return launch_chunked_k<16>(r, k, v, lw, u, o, n_b, n_t, n_h, s);
    case 32:
      return launch_chunked_k<32>(r, k, v, lw, u, o, n_b, n_t, n_h, s);
    case 64:
      return launch_chunked_k<64>(r, k, v, lw, u, o, n_b, n_t, n_h, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"

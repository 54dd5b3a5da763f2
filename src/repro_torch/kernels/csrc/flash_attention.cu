// Blocked causal / sliding-window / full attention with an online softmax,
// forward only, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention
// (_attn_kernel), the Pallas TPU kernel reached from
// models/layers.py::attention_block through kernels/ops.py::routed_attention.
//
// What bounds it: the arithmetic.  At the main path's shape (h2o-danube-3:
// B = 2, S = 4096, 32 query heads over 8 kv heads, D = 120, bf16, causal,
// window 8192 >= S) the two products QK^T and PV over the causal half are
// about 2.6e11 FLOP (0.26 ms at the card's 989 TFLOP/s bf16 tensor-core
// peak) against about 0.16 GB of inputs and output (0.05 ms at 3.35 TB/s).
// This kernel does that arithmetic with f32 FMAs on the CUDA cores (67
// TFLOP/s peak, so at least ~4 ms), which is the simple and exact
// first version; tensor cores (wgmma) and TMA are later work.
//
// Design.  The TPU kernel walks kv blocks on a sequential grid axis and
// keeps the running max m, denominator l and the f32 accumulator in VMEM
// between grid steps; the wrapper there repeats k/v for GQA and pads D to
// 128.  Here one CTA of 8 warps owns one (b, query head) and a block of 64
// query rows, and loops over kv blocks of 64 keys itself:
//   * q, k and v are read in the model's (B, S, H, D) layout through their
//     strides; the kv head is h / (Hq / Hkv), so k/v are never repeated,
//     and D (<= 128) is not padded, so the scale is 1/sqrt(D) of the true D;
//   * the CTA stages its q block (64 x D), then each kv block's K
//     transposed (D x 65, the pad column makes both the staging stores and
//     the per-lane reads bank-conflict free) and V (64 x D) in shared
//     memory, widened to f32;
//   * each warp owns 8 query rows; lane l scores keys l and l + 32 of the
//     block for those rows (16 f32 dot products, q read as broadcast
//     float4), and owns output columns l, l + 32, l + 64, l + 96, so the
//     accumulator is 8 x 4 registers per lane;
//   * the row max is a warp shuffle reduction; the denominator l is kept as
//     per-lane partial sums and reduced once at the end; P V broadcasts
//     each probability with a shuffle;
//   * kv blocks wholly above the diagonal, or wholly outside the window,
//     are skipped, as flash_attention.py:42-46 skips them; masked scores
//     are -1e30 as there (:62), m starts at -1e30, and the output is
//     acc / max(l, 1e-30) (:75), written in the input type.
// A row whose first visited block is fully masked (only possible with a
// window) accumulates garbage with weight exp(0) until its first real key
// arrives; the rescale exp(-1e30 - m) = 0 then clears it exactly, as in
// the TPU kernel.  Keys past S are masked and their V rows zero-filled.
// No atomics: the same inputs give the same bits on every run.
// The wrapper (kernels/ops.py) allocates o; the C entry points launch on
// the caller's stream and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBlockQ = 64;                       // query rows per CTA
constexpr int kBlockK = 64;                       // keys per kv block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kBlockQ / kWarps;           // query rows per warp
constexpr int kMaxD = 128;
constexpr int kCols = kMaxD / 32;                 // output columns per lane
constexpr int kKtStride = kBlockK + 1;            // padded row of K^T
constexpr float kMaskValue = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

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

// Shared memory floats for head dim d: q block, K^T block, V block.
__host__ __device__ __forceinline__ int smem_floats(int d) {
  const int d4 = (d + 3) & ~3;
  return kBlockQ * d4 + d4 * kKtStride + kBlockK * d;
}

// acc[r][c] += sum over the 32 keys of one half-block of p[r] * V[key][col]
// (the probability of key `half * 32 + jj` lives in lane jj of p[r]).
__device__ __forceinline__ void accumulate_pv(
    const float (&p)[kRows], const float* __restrict__ v_s, int half, int d,
    int lane, float (&acc)[kRows][kCols]) {
#pragma unroll 4
  for (int jj = 0; jj < 32; ++jj) {
    const float* vrow = v_s + (half * 32 + jj) * d;
    float vv[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      vv[c] = col < d ? vrow[col] : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float pj = __shfl_sync(kFull, p[r], jj);
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(pj, vv[c], acc[r][c]);
    }
  }
}

// q: (B, S, Hq, D), k/v: (B, S, Hkv, D) with the given element strides for
// batch, sequence and head, and unit stride over D; o: contiguous
// (B, S, Hq, D).  Grid: (ceil(S / kBlockQ), B * Hq) CTAs of kThreads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int n_s,
                       int n_hq, int n_hkv, int d, long long q_sb,
                       long long q_ss, long long q_sh, long long k_sb,
                       long long k_ss, long long k_sh, long long v_sb,
                       long long v_ss, long long v_sh, float scale,
                       int causal, int window) {
  extern __shared__ float smem[];
  const int d4 = (d + 3) & ~3;
  float* q_s = smem;                               // [kBlockQ][d4]
  float* kt_s = q_s + kBlockQ * d4;                // [d4][kKtStride]
  float* v_s = kt_s + d4 * kKtStride;              // [kBlockK][d]

  const int q_start = blockIdx.x * kBlockQ;
  const int b = blockIdx.y / n_hq;
  const int h = blockIdx.y % n_hq;
  const int hk = h / (n_hq / n_hkv);
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  for (int e = tid; e < kBlockQ * d4; e += kThreads) {
    const int row = e / d4;
    const int col = e - row * d4;
    const int sq = q_start + row;
    q_s[e] = (sq < n_s && col < d) ? to_f32(qb[sq * q_ss + col]) : 0.0f;
  }

  // the kv blocks that meet this query block's mask
  const int q_last = min(q_start + kBlockQ, n_s) - 1;
  const int kb_end = causal ? q_last / kBlockK + 1
                            : (n_s + kBlockK - 1) / kBlockK;
  const int kb_begin =
      (causal && window > 0) ? max(0, q_start - window + 1) / kBlockK : 0;

  float m[kRows];
  float l[kRows];
  float acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kMaskValue;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;
  }
  const float* q_w = q_s + warp * kRows * d4;

  for (int kbi = kb_begin; kbi < kb_end; ++kbi) {
    const int k_start = kbi * kBlockK;
    __syncthreads();            // the previous block's tiles are consumed
    for (int e = tid; e < kBlockK * d4; e += kThreads) {
      const int key = e / d4;
      const int col = e - key * d4;
      const int sk = k_start + key;
      kt_s[col * kKtStride + key] =
          (sk < n_s && col < d) ? to_f32(kb[sk * k_ss + col]) : 0.0f;
    }
    for (int e = tid; e < kBlockK * d; e += kThreads) {
      const int key = e / d;
      const int col = e - key * d;
      const int sk = k_start + key;
      v_s[e] = sk < n_s ? to_f32(vb[sk * v_ss + col]) : 0.0f;
    }
    __syncthreads();

    // scores of this warp's rows against keys lane and lane + 32
    float s0[kRows];
    float s1[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      s0[r] = 0.0f;
      s1[r] = 0.0f;
    }
    for (int dd = 0; dd < d4; dd += 4) {
      float k0[4];
      float k1[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        k0[c] = kt_s[(dd + c) * kKtStride + lane];
        k1[c] = kt_s[(dd + c) * kKtStride + lane + 32];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(q_w + r * d4 + dd);
        s0[r] = fmaf(qv.x, k0[0], s0[r]);
        s0[r] = fmaf(qv.y, k0[1], s0[r]);
        s0[r] = fmaf(qv.z, k0[2], s0[r]);
        s0[r] = fmaf(qv.w, k0[3], s0[r]);
        s1[r] = fmaf(qv.x, k1[0], s1[r]);
        s1[r] = fmaf(qv.y, k1[1], s1[r]);
        s1[r] = fmaf(qv.z, k1[2], s1[r]);
        s1[r] = fmaf(qv.w, k1[3], s1[r]);
      }
    }

    // mask, online softmax; s0/s1 become the probabilities
    const int kp0 = k_start + lane;
    const int kp1 = kp0 + 32;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qp = q_start + warp * kRows + r;
      bool ok0 = kp0 < n_s;
      bool ok1 = kp1 < n_s;
      if (causal) {
        ok0 = ok0 && kp0 <= qp;
        ok1 = ok1 && kp1 <= qp;
        if (window > 0) {
          ok0 = ok0 && qp - kp0 < window;
          ok1 = ok1 && qp - kp1 < window;
        }
      }
      const float x0 = ok0 ? s0[r] * scale : kMaskValue;
      const float x1 = ok1 ? s1[r] * scale : kMaskValue;
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      }
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      s0[r] = expf(x0 - m_new);
      s1[r] = expf(x1 - m_new);
      l[r] = l[r] * alpha + s0[r] + s1[r];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
      m[r] = m_new;
    }

    accumulate_pv(s0, v_s, 0, d, lane, acc);
    accumulate_pv(s1, v_s, 1, d, lane, acc);
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float denom = l[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      denom += __shfl_xor_sync(kFull, denom, off);
    }
    denom = fmaxf(denom, 1e-30f);
    const int qp = q_start + warp * kRows + r;
    if (qp >= n_s) continue;
    T* orow = o + ((static_cast<size_t>(b) * n_s + qp) * n_hq + h) * d;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      if (col < d) orow[col] = from_f32<T>(acc[r][c] / denom);
    }
  }
}

template <typename T>
int launch_flash(const void* q, const void* k, const void* v, void* o,
                 int n_b, int n_s, int n_hq, int n_hkv, int d,
                 const long long* q_strides, const long long* k_strides,
                 const long long* v_strides, float scale, int causal,
                 int window, cudaStream_t stream) {
  if (n_b < 1 || n_s < 1 || n_hq < 1 || n_hkv < 1 || n_hq % n_hkv != 0 ||
      d < 1 || d > kMaxD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(smem_floats(d)) * sizeof(float);
  static bool smem_set = false;      // once per type, before any capture
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_floats(kMaxD) * sizeof(float)));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const dim3 grid((n_s + kBlockQ - 1) / kBlockQ, n_b * n_hq);
  flash_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), n_s, n_hq, n_hkv, d,
      q_strides[0], q_strides[1], q_strides[2], k_strides[0], k_strides[1],
      k_strides[2], v_strides[0], v_strides[1], v_strides[2], scale, causal,
      window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q: (n_b, n_s, n_hq, d), k/v: (n_b, n_s, n_hkv, d), each with element
// strides {batch, sequence, head} and unit stride over d; o contiguous
// (n_b, n_s, n_hq, d).  All f32.  d <= 128, n_hq a multiple of n_hkv.
// causal != 0 masks keys after the query; window > 0 (causal only) also
// masks keys window or more positions before it.
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int n_b, int n_s, int n_hq, int n_hkv, int d,
                        const long long* q_strides,
                        const long long* k_strides,
                        const long long* v_strides, float scale, int causal,
                        int window, void* stream) {
  return launch_flash<float>(q, k, v, o, n_b, n_s, n_hq, n_hkv, d, q_strides,
                             k_strides, v_strides, scale, causal, window,
                             static_cast<cudaStream_t>(stream));
}

// The same in bf16; scores, softmax and the accumulator stay f32.
int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* o, int n_b, int n_s, int n_hq, int n_hkv,
                         int d, const long long* q_strides,
                         const long long* k_strides,
                         const long long* v_strides, float scale, int causal,
                         int window, void* stream) {
  return launch_flash<__nv_bfloat16>(q, k, v, o, n_b, n_s, n_hq, n_hkv, d,
                                     q_strides, k_strides, v_strides, scale,
                                     causal, window,
                                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"

// Blocked causal / sliding-window / full attention with an online softmax,
// forward only, for Hopper (sm_90a).  Two variants of one function.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention
// (_attn_kernel), the Pallas TPU kernel reached from
// models/layers.py::attention_block through kernels/ops.py::routed_attention.
// The function is _attn_kernel's: q (B, S, Hq, D), k/v (B, S, Hkv, D) read
// in the model's layout through their strides, query head h reads kv head
// h / (Hq / Hkv) (no k/v repeat), scale 1/sqrt(D) of the true D, masked
// scores -1e30, m starting at -1e30, output acc / max(l, 1e-30) in the
// input type.  Keys past the diagonal, or window or more positions before
// the query (causal only), are masked; kv tiles wholly outside the mask
// are skipped, as flash_attention.py:42-46 skips them.  A row whose first
// visited tile is fully masked (only possible with a window) accumulates
// with weight exp(0) until its first real key arrives; the rescale
// exp(-1e30 - m) = 0 then clears it exactly, as in the TPU kernel.  No
// atomics: each output element has one owner, so the same inputs give the
// same bits on every run.
//
// What bounds it: the arithmetic.  At the main path's shape (h2o-danube-3:
// B = 2, S = 4096, 32 query heads over 8 kv heads, D = 120, bf16, causal,
// window 8192 >= S) QK^T and PV over the causal half are about 2.6e11 FLOP,
// 0.26 ms at the card's 989 TFLOP/s bf16 tensor-core peak, against about
// 0.16 GB of inputs and output (0.05 ms at 3.35 TB/s).  Only the tensor
// cores come near that, hence the wgmma variant.
//
// The wgmma variant (bf16, D a multiple of 8 up to 128, 16-byte-aligned
// pointers, strides in multiples of 8 elements; ops.flash_route picks it):
// the FA3 layout.  A work item is 128 query rows of one (b, query head);
// a CTA has three warpgroups:
//   * a producer warpgroup (setmaxnreg down to 40 registers) in which one
//     thread issues TMA loads: each item's q tile into one of two q
//     buffers, then its 128-key K and V tiles into a two-stage ring, each
//     load completing on its own "full" mbarrier and freed by the
//     consumers through an "empty" one (parity per lap of the ring);
//   * two consumer warpgroups of 64 query rows each (setmaxnreg up to 232).
// Each operand has one 4-D tensor map (D, H, S, B) with the caller's byte
// strides, 128-byte swizzle and 64 x 1 x 128 x 1 boxes, so two boxes cover
// D <= 128.  Columns past D (120..127 at D = 120, 64..127 at D = 64)
// and rows past S fall out of bounds and TMA fills them with zeros, so
// the products over the padded width are exact and no load is masked.
// S = QK^T is wgmma m64n128k16 with Q and K both K-major from shared
// memory (the descriptor start moves 32 bytes per 16-column step inside a
// swizzle atom, then a box on).  The online softmax runs on the f32
// accumulator fragment: thread (warp w, lane l) holds rows 16w + l/4 and
// +8 and columns 8j + 2(l%4) + {0,1}; row max and sum reduce over the four
// lanes of a row; masks apply element by element only on tiles that cross
// the diagonal, the window edge or S; exp2 with log2(e) folded into the
// scale.  P is rounded to bf16 in registers: its accumulator fragment,
// packed in pairs, is exactly the register-A fragment of the next wgmma,
// O += P V, with V read from shared memory MN-major (D contiguous, the
// transpose bit set), so V is never transposed.  The PV product is 128
// wide; columns past D are zeros and dropped.  A tile's QK^T is issued
// together with the previous tile's PV and its softmax runs between the
// two waits; named barriers give the two warpgroups turns at issuing, so
// one's softmax overlaps the other's products.  The epilogue scales by
// 1/l and writes bf16 rows < S and columns < D straight from registers.
// Schedule: item i is q tile (last - i / (B * Hq)) of (b, head) i % (B * Hq),
// so the longest causal rows come first and the query heads sharing a kv
// head run side by side (k/v stay in L2).  The grid is persistent and
// static: one CTA per SM walks the items round by round, snaking, with no
// counter (nothing to reset under graph capture); the ring runs on across
// a CTA's items, so one item's loads overlap the last one's epilogue.
// Each output tile still has one owner, so the bits do not depend on the
// grid.  Rounding: P is rounded to bf16 before the PV product, as
// kernels/ref.py::attention_ref does (:30); the Pallas kernel keeps P in
// f32, within the 2e-2 bf16 tolerance of each other.
//
// The SIMT variant (f32 inputs, and bf16 the wgmma variant does not take,
// such as the danube smoke config's D = 12): f32 FMAs on the CUDA cores,
// kept from the first port.  One CTA of 8 warps owns 64 query rows of one
// (b, query head) and loops over 64-key blocks: the q block, each block's K
// transposed (a padded row of 65 floats, so staging stores and per-lane
// reads are bank-conflict free) and V are staged in shared memory in f32;
// each warp owns 8 query rows, lane l scores keys l and l + 32 and owns
// output columns l + 32c; the row max is a shuffle reduction, l stays
// per-lane until the end, P V broadcasts each probability with a shuffle.
// TF32 wgmma could not hold f32 to 1e-5, so f32 stays here.
//
// The wrapper (kernels/ops.py) allocates o (contiguous (B, S, Hq, D)); the
// C entry points launch on the caller's stream and return
// cudaGetLastError() (or cudaErrorInvalidValue for arguments a kernel does
// not take, and 1000 + the CUresult when a tensor map cannot be encoded).
// Tensor maps are encoded on the host at every call (the pointers change)
// and passed by value as __grid_constant__ parameters, which CUDA-graph
// capture records by value.  cuTensorMapEncodeTiled comes through
// cudaGetDriverEntryPoint, so the library needs no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr float kMaskValue = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxD = 128;

// ---------------------------------------------------------------------------
// SIMT variant
// ---------------------------------------------------------------------------
namespace simt {

constexpr int kBlockQ = 64;                       // query rows per CTA
constexpr int kBlockK = 64;                       // keys per kv block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kBlockQ / kWarps;           // query rows per warp
constexpr int kCols = kMaxD / 32;                 // output columns per lane
constexpr int kKtStride = kBlockK + 1;            // padded row of K^T

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
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int n_s,
                 int n_hq, int n_hkv, int d, long long q_sb, long long q_ss,
                 long long q_sh, long long k_sb, long long k_ss,
                 long long k_sh, long long v_sb, long long v_ss,
                 long long v_sh, float scale, int causal, int window) {
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
int launch(const void* q, const void* k, const void* v, void* o, int n_b,
           int n_s, int n_hq, int n_hkv, int d, const long long* q_strides,
           const long long* k_strides, const long long* v_strides,
           float scale, int causal, int window, cudaStream_t stream) {
  if (n_b < 1 || n_s < 1 || n_hq < 1 || n_hkv < 1 || n_hq % n_hkv != 0 ||
      d < 1 || d > kMaxD || static_cast<long long>(n_b) * n_hq > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(smem_floats(d)) * sizeof(float);
  static bool smem_set = false;      // once per type, before any capture
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_floats(kMaxD) * sizeof(float)));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const dim3 grid((n_s + kBlockQ - 1) / kBlockQ, n_b * n_hq);
  attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), n_s, n_hq, n_hkv, d,
      q_strides[0], q_strides[1], q_strides[2], k_strides[0], k_strides[1],
      k_strides[2], v_strides[0], v_strides[1], v_strides[2], scale, causal,
      window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

// ---------------------------------------------------------------------------
// wgmma variant
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kBlockM = 128;        // query rows per CTA (two warpgroups)
constexpr int kBlockN = 128;        // keys per kv tile
constexpr int kBoxCols = 64;        // head columns per TMA box (128 bytes)
constexpr int kBoxBytes = 128 * kBoxCols * 2;        // 16 KB
constexpr int kTileBytes = 2 * kBoxBytes;            // 128 rows x 128 cols
constexpr int kStages = 2;
constexpr int kThreads = 3 * 128;
constexpr int kConsumerWarps = 8;
// two q tiles, the K and V rings, twelve mbarriers; +1024 to align the
// tiles (the 128-byte swizzle repeats every 1024 bytes)
constexpr int kSmemBytes = (2 + 2 * kStages) * kTileBytes + 256 + 1024;
constexpr float kLog2e = 1.4426950408889634f;

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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
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
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// A shared-memory matrix descriptor for a 128-byte-swizzled operand:
// start address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major (Q, K): rows of 128 bytes, 8-row groups 1024 bytes apart; the
// leading offset is unused with this swizzle.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return smem_desc(addr, 16, 1024);
}

// MN-major (V): 64 head columns per 128-byte row, the next 64 one box
// (16 KB) on; 8-key groups 1024 bytes apart.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) {
  return smem_desc(addr, kBoxBytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The accumulator operands of one wgmma, four registers at a time.
#define FA_ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])

// d (64 x 128, f32) = A B^T (+ d if accumulate): A 64 x 16 and B 128 x 16,
// both bf16 K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : FA_ACC4(0), FA_ACC4(4), FA_ACC4(8), FA_ACC4(12),
      FA_ACC4(16), FA_ACC4(20), FA_ACC4(24), FA_ACC4(28),
      FA_ACC4(32), FA_ACC4(36), FA_ACC4(40), FA_ACC4(44),
      FA_ACC4(48), FA_ACC4(52), FA_ACC4(56), FA_ACC4(60)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 128, f32) += A B: A 64 x 16 bf16 in registers (the accumulator
// fragment layout, two values per register), B 16 x 128 bf16 MN-major in
// shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : FA_ACC4(0), FA_ACC4(4), FA_ACC4(8), FA_ACC4(12),
      FA_ACC4(16), FA_ACC4(20), FA_ACC4(24), FA_ACC4(28),
      FA_ACC4(32), FA_ACC4(36), FA_ACC4(40), FA_ACC4(44),
      FA_ACC4(48), FA_ACC4(52), FA_ACC4(56), FA_ACC4(60)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

#undef FA_ACC4

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Named barriers 1 and 2 order the two consumer warpgroups' wgmma issue
// (barrier 0 is __syncthreads): 256 threads, one warpgroup syncing and
// the other arriving.
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// Issue S = Q K^T over the 128 padded head columns, 16 per step: the
// start address moves 32 bytes per step inside a box's swizzle atom, then
// a box on.
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint32_t q_tile,
                                         uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < kMaxD / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    wgmma_ss(sc, kmajor_desc(q_tile + off), kmajor_desc(k_tile + off),
             kk > 0);
  }
}

// Issue O += P V over 128 keys (16 per step, 2048 bytes of V each), 128
// head columns wide.
__device__ __forceinline__ void issue_pv(float (&acc)[64],
                                         const uint32_t (&p)[32],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    wgmma_rs(acc, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
             mnmajor_desc(v_tile + kk * 2048));
  }
}

// The online softmax over one tile's scores (this thread's two rows):
// m (running max, log2 units after the scale) and the per-thread partial
// l are updated, alpha gets each row's rescale factor and sc becomes the
// probabilities in f32.  The masked form sets the scaled score of a
// masked (query, key) pair to -1e30 (a row masked across the whole tile
// then takes exp2(0) = 1 per key until a real key clears it); the
// unmasked form takes the max of the raw scores and folds the scale into
// one FMA per score.
template <bool kMasked>
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             float c, int k_start, int row0,
                                             int col0, int n_s, int causal,
                                             int window) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    const int r = (e >> 1) & 1;
    if (kMasked) {
      const int key = k_start + (e >> 2) * 8 + col0 + (e & 1);
      const int qp = row0 + 8 * r;
      bool ok = key < n_s;
      if (causal) ok = ok && key <= qp && (window <= 0 || qp - key < window);
      sc[e] = ok ? sc[e] * c : kMaskValue;
    }
    mx[r] = fmaxf(mx[r], sc[e]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
    const float m_new = fmaxf(m[r], kMasked ? mx[r] : mx[r] * c);
    alpha[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    const int r = (e >> 1) & 1;
    sc[e] = kMasked ? ex2(sc[e] - m[r]) : ex2(fmaf(sc[e], c, -m[r]));
    l[r] += sc[e];
  }
}

// One work item is one (b, query head) and 128-row q tile; item i takes q
// tile n_qt - 1 - i / n_bh and (b, head) i % n_bh, so the longest causal
// rows come first and the query heads of one kv head run side by side.
struct Item {
  int b, h, q_first, t_begin, n_tiles;
};

__device__ __forceinline__ Item item_at(int i, int n_s, int n_hq, int n_bh,
                                        int causal, int window) {
  const int n_qt = (n_s + kBlockM - 1) / kBlockM;
  Item it;
  const int bh = i % n_bh;
  it.b = bh / n_hq;
  it.h = bh % n_hq;
  it.q_first = (n_qt - 1 - i / n_bh) * kBlockM;
  // the kv tiles that meet this query tile's mask
  const int q_last = min(it.q_first + kBlockM, n_s) - 1;
  const int t_end =
      causal ? q_last / kBlockN + 1 : (n_s + kBlockN - 1) / kBlockN;
  it.t_begin =
      (causal && window > 0) ? max(0, it.q_first - window + 1) / kBlockN : 0;
  it.n_tiles = t_end - it.t_begin;
  return it;
}

// The j-th item of this CTA: round j takes one item per CTA, in CTA order
// on even rounds and reversed on odd ones, so each CTA's total work evens
// out.  A grid of one CTA per item gives each CTA item blockIdx.x.
__device__ __forceinline__ int item_of(int j) {
  const int g = gridDim.x;
  return j * g + ((j & 1) ? g - 1 - blockIdx.x : blockIdx.x);
}

// Grid: G CTAs of kThreads walk the n_items items (see item_of).  The
// products cover 128 head columns (two TMA boxes per tile); columns past D
// are zeros.
__global__ void __launch_bounds__(kThreads, 1)
attention_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 __nv_bfloat16* __restrict__ o, int n_s, int n_hq, int n_hkv,
                 int d, float scale_log2, int causal, int window,
                 int n_items) {
  constexpr int kBoxes = kTileBytes / kBoxBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;                               // two q buffers
  const uint32_t k_s = base + 2 * kTileBytes;              // + stage tiles
  const uint32_t v_s = base + (2 + kStages) * kTileBytes;  // + stage tiles
  const uint32_t bars = base + (2 + 2 * kStages) * kTileBytes;
  auto q_full = [&](int qb) { return bars + 8u * qb; };
  auto q_empty = [&](int qb) { return bars + 8u * (2 + qb); };
  auto k_full = [&](int s) { return bars + 8u * (4 + s); };
  auto v_full = [&](int s) { return bars + 8u * (4 + kStages + s); };
  auto k_empty = [&](int s) { return bars + 8u * (4 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return bars + 8u * (4 + 3 * kStages + s); };
  const int n_bh = n_items / ((n_s + kBlockM - 1) / kBlockM);

  if (threadIdx.x == 0) {
    for (int qb = 0; qb < 2; ++qb) {
      mbar_init(q_full(qb), 1);
      mbar_init(q_empty(qb), kConsumerWarps);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), kConsumerWarps);
      mbar_init(v_empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      const uint32_t bytes = kTileBytes;
      int pos = 0;                       // ring position across items
      for (int j = 0; item_of(j) < n_items; ++j) {
        const Item it = item_at(item_of(j), n_s, n_hq, n_bh, causal, window);
        const int hk = it.h / (n_hq / n_hkv);
        const int qb = j & 1;
        mbar_wait(q_empty(qb), ((j >> 1) & 1) ^ 1);
        mbar_expect_tx(q_full(qb), bytes);
        for (int bx = 0; bx < kBoxes; ++bx) {
          tma_load(q_s + qb * kTileBytes + bx * kBoxBytes, &tm_q, q_full(qb),
                   bx * kBoxCols, it.h, it.q_first, it.b);
        }
        for (int i = 0; i < it.n_tiles; ++i, ++pos) {
          const int s = pos % kStages;
          const uint32_t lap = (pos / kStages) & 1;
          const int k_start = (it.t_begin + i) * kBlockN;
          mbar_wait(k_empty(s), lap ^ 1);
          mbar_expect_tx(k_full(s), bytes);
          for (int bx = 0; bx < kBoxes; ++bx) {
            tma_load(k_s + s * kTileBytes + bx * kBoxBytes, &tm_k, k_full(s),
                     bx * kBoxCols, hk, k_start, it.b);
          }
          mbar_wait(v_empty(s), lap ^ 1);
          mbar_expect_tx(v_full(s), bytes);
          for (int bx = 0; bx < kBoxes; ++bx) {
            tma_load(v_s + s * kTileBytes + bx * kBoxBytes, &tm_v, v_full(s),
                     bx * kBoxCols, hk, k_start, it.b);
          }
        }
      }
    }
  } else {
    // ---- two consumer warpgroups of 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = (threadIdx.x - 128) / 128;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int row_in_wg = (t / 32) * 16 + lane / 4;   // and + 8
    const int col0 = 2 * (lane % 4);
    const int my_turn = 1 + wg;
    const int other_turn = 2 - wg;
    float acc[kMaxD / 2];
    float sc[64];
    uint32_t p[32];
    float m[2], l[2], alpha[2];
    if (wg == 1) bar_arrive(1);   // warpgroup 0 issues first

    int pos = 0;                         // ring position across items
    for (int j = 0; item_of(j) < n_items; ++j) {
      const Item it = item_at(item_of(j), n_s, n_hq, n_bh, causal, window);
      const bool last_item = item_of(j + 1) >= n_items;
      const int wg_first = it.q_first + wg * 64;
      const int row0 = wg_first + row_in_wg;
      const int qb = j & 1;
      const uint32_t q_wg = q_s + qb * kTileBytes + wg * 64 * 128;
      // a tile crossing the diagonal, the window edge or S is masked
      const auto softmax = [&](int k_start) {
        if (k_start + kBlockN > n_s ||
            (causal && (k_start + kBlockN - 1 > wg_first ||
                        (window > 0 && wg_first + 63 - k_start >= window)))) {
          softmax_tile<true>(sc, m, l, alpha, scale_log2, k_start, row0,
                             col0, n_s, causal, window);
        } else {
          softmax_tile<false>(sc, m, l, alpha, scale_log2, k_start, row0,
                              col0, n_s, causal, window);
        }
      };
#pragma unroll
      for (int e = 0; e < kMaxD / 2; ++e) acc[e] = 0.0f;
      m[0] = m[1] = kMaskValue;
      l[0] = l[1] = 0.0f;

      // the first tile: S alone
      mbar_wait(q_full(qb), (j >> 1) & 1);
      mbar_wait(k_full(pos % kStages), (pos / kStages) & 1);
      bar_sync(my_turn);
      wgmma_fence();
      issue_qk(sc, q_wg, k_s + (pos % kStages) * kTileBytes);
      wgmma_commit();
      bar_arrive(other_turn);
      wgmma_wait<0>();
      fence_regs(sc);
      if (lane == 0) mbar_arrive(k_empty(pos % kStages));
      softmax(it.t_begin * kBlockN);
#pragma unroll
      for (int e = 0; e < 64; e += 2) p[e / 2] = pack_bf16(sc[e], sc[e + 1]);

      for (int i = 1; i < it.n_tiles; ++i) {
        const int cur = pos + i;
        const int s = cur % kStages;
        const int sp = (cur - 1) % kStages;
        mbar_wait(k_full(s), (cur / kStages) & 1);
        mbar_wait(v_full(sp), ((cur - 1) / kStages) & 1);
        bar_sync(my_turn);
        wgmma_fence();
        issue_qk(sc, q_wg, k_s + s * kTileBytes);
        wgmma_commit();
        issue_pv(acc, p, v_s + sp * kTileBytes);
        wgmma_commit();
        bar_arrive(other_turn);
        wgmma_wait<1>();                 // S of tile i is in
        fence_regs(sc);
        if (lane == 0) mbar_arrive(k_empty(s));
        softmax((it.t_begin + i) * kBlockN);
        wgmma_wait<0>();                 // P V of tile i - 1 is in
        fence_regs(acc);
        if (lane == 0) mbar_arrive(v_empty(sp));
#pragma unroll
        for (int e = 0; e < kMaxD / 2; ++e) acc[e] *= alpha[(e >> 1) & 1];
#pragma unroll
        for (int e = 0; e < 64; e += 2) p[e / 2] = pack_bf16(sc[e], sc[e + 1]);
      }

      // the last tile's P V
      pos += it.n_tiles;
      const int sl = (pos - 1) % kStages;
      mbar_wait(v_full(sl), ((pos - 1) / kStages) & 1);
      bar_sync(my_turn);
      wgmma_fence();
      issue_pv(acc, p, v_s + sl * kTileBytes);
      wgmma_commit();
      // warpgroup 1's last turn of its last item has no turn after it
      if (wg == 0 || !last_item) bar_arrive(other_turn);
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) {
        mbar_arrive(v_empty(sl));
        mbar_arrive(q_empty(qb));        // the q tile is free for item j + 2
      }

      // epilogue: 1 / l, bf16, rows < S and columns < D
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(kFull, l[r], 1);
        l[r] += __shfl_xor_sync(kFull, l[r], 2);
        inv[r] = 1.0f / fmaxf(l[r], 1e-30f);
      }
#pragma unroll
      for (int jj = 0; jj < kMaxD / 8; ++jj) {
        const int col = 8 * jj + col0;
        if (col >= d) continue;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int qp = row0 + 8 * r;
          if (qp >= n_s) continue;
          __nv_bfloat16* dst =
              o + ((static_cast<size_t>(it.b) * n_s + qp) * n_hq + it.h) * d +
              col;
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(
              acc[4 * jj + 2 * r] * inv[r], acc[4 * jj + 2 * r + 1] * inv[r]);
        }
      }
    }
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

// The (D, H, S, B) tensor map of one bf16 operand with element strides
// {batch, sequence, head}.  A dimension of extent 1 is never stepped, so
// its stride is replaced by a packed one TMA takes.  Returns 0, or the
// error the C entry point returns.
int encode(CUtensorMap* map, const void* ptr, int n_b, int n_s, int n_h,
           int d, const long long* strides) {
  const EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(n_h),
                              static_cast<cuuint64_t>(n_s),
                              static_cast<cuuint64_t>(n_b)};
  const long long given[3] = {strides[2], strides[1], strides[0]};
  cuuint64_t bytes[3];
  long long packed = d;
  for (int i = 0; i < 3; ++i) {
    const long long extent = static_cast<long long>(dims[i + 1]);
    const long long stride = extent == 1 ? packed : given[i];
    if (stride <= 0 || stride % 8 != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    bytes[i] = static_cast<cuuint64_t>(stride) * 2;
    packed = stride * extent;
  }
  const cuuint32_t box[4] = {kBoxCols, 1, kBlockN, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
         dims, bytes, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : 1000 + static_cast<int>(res);
}

int launch(const void* q, const void* k, const void* v, void* o, int n_b,
           int n_s, int n_hq, int n_hkv, int d, const long long* q_strides,
           const long long* k_strides, const long long* v_strides,
           float scale, int causal, int window, cudaStream_t stream) {
  const auto misaligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if (n_b < 1 || n_s < 1 || n_hq < 1 || n_hkv < 1 || n_hq % n_hkv != 0 ||
      d < 8 || d > kMaxD || d % 8 != 0 ||
      static_cast<long long>(n_b) * n_hq * ((n_s + kBlockM - 1) / kBlockM) >
          0x7fffffffLL ||
      misaligned(q) ||
      misaligned(k) || misaligned(v) || misaligned(o)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, q, n_b, n_s, n_hq, d, q_strides);
  if (err == 0) err = encode(&tk, k, n_b, n_s, n_hkv, d, k_strides);
  if (err == 0) err = encode(&tv, v, n_b, n_s, n_hkv, d, v_strides);
  if (err != 0) return err;
  static bool smem_set = false;      // once, before any capture
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  // a persistent grid: one CTA per SM (or per item, if fewer) walks the
  // items in a fixed order, so no counter needs resetting between launches
  int dev = 0;
  int sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_items = n_b * n_hq * ((n_s + kBlockM - 1) / kBlockM);
  attention_kernel<<<sms < n_items ? sms : n_items, kThreads, kSmemBytes,
                     stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), n_s,
                               n_hq, n_hkv, d, scale * kLog2e, causal, window,
                               n_items);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

extern "C" {

// q: (n_b, n_s, n_hq, d), k/v: (n_b, n_s, n_hkv, d), each with element
// strides {batch, sequence, head} and unit stride over d; o contiguous
// (n_b, n_s, n_hq, d).  d <= 128, n_hq a multiple of n_hkv, n_b * n_hq <=
// 65535.  causal != 0 masks keys after the query; window > 0 (causal only)
// also masks keys window or more positions before it.  All f32.
int flash_attention_simt_f32(const void* q, const void* k, const void* v,
                             void* o, int n_b, int n_s, int n_hq, int n_hkv,
                             int d, const long long* q_strides,
                             const long long* k_strides,
                             const long long* v_strides, float scale,
                             int causal, int window, void* stream) {
  return simt::launch<float>(q, k, v, o, n_b, n_s, n_hq, n_hkv, d, q_strides,
                             k_strides, v_strides, scale, causal, window,
                             static_cast<cudaStream_t>(stream));
}

// The same in bf16 on the CUDA cores; scores, softmax and the accumulator
// stay f32.
int flash_attention_simt_bf16(const void* q, const void* k, const void* v,
                              void* o, int n_b, int n_s, int n_hq, int n_hkv,
                              int d, const long long* q_strides,
                              const long long* k_strides,
                              const long long* v_strides, float scale,
                              int causal, int window, void* stream) {
  return simt::launch<__nv_bfloat16>(q, k, v, o, n_b, n_s, n_hq, n_hkv, d,
                                     q_strides, k_strides, v_strides, scale,
                                     causal, window,
                                     static_cast<cudaStream_t>(stream));
}

// The same in bf16 on the tensor cores (wgmma, TMA): d a multiple of 8,
// pointers 16-byte aligned, every stride of an extent above 1 a positive
// multiple of 8 elements, n_b * n_hq * ceil(n_s / 128) < 2^31.  P is
// rounded to bf16 before the PV product.
int flash_attention_wgmma_bf16(const void* q, const void* k, const void* v,
                               void* o, int n_b, int n_s, int n_hq,
                               int n_hkv, int d, const long long* q_strides,
                               const long long* k_strides,
                               const long long* v_strides, float scale,
                               int causal, int window, void* stream) {
  return tc::launch(q, k, v, o, n_b, n_s, n_hq, n_hkv, d, q_strides,
                    k_strides, v_strides, scale, causal, window,
                    static_cast<cudaStream_t>(stream));
}

}  // extern "C"

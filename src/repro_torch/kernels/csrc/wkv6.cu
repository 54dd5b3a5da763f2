// RWKV6 WKV recurrence, output only, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/wkv6.py::wkv6 (_wkv6_kernel), the Pallas TPU
// kernel reached from models/ssm.py::rwkv6_time_mix through
// kernels/ops.py::routed_wkv6.  Per (batch b, head h), with a K x K f32
// state S that starts at zero:
//   o_t = r_t . (S + diag(u) k_t v_t^T)
//   S   <- diag(exp(lw_t)) S + k_t v_t^T
// r, k, v, u in one type (f32 or bf16), lw in f32 (the model computes the
// decay in f32), o in r's type; the final state is not returned.
//
// What bounds it: the serial chain over T.  At the main path's shape
// (B = 2, T = 4096, H = 64, K = 64; bf16 r/k/v/u, f32 lw) the inputs and
// the output are about 0.40 GB (0.12 ms at 3.35 TB/s) and the arithmetic
// about 6.4 GFLOP (0.10 ms at 67 TFLOP/s f32), but every step depends on
// the one before, so the time is T times the latency of one step of one
// CTA, not bytes or FLOPs.
//
// Design.  The TPU kernel keeps S in VMEM across a sequential grid of time
// chunks.  Here, as in the original RWKV CUDA kernel, one CTA owns one
// (b, h) and runs the whole time loop; thread j of its K threads holds
// column j of S in registers (K <= 64, a template parameter, so the state
// array is fully unrolled into registers).  The CTA stages a chunk of
// kChunk steps of r, k, exp(lw) and v in shared memory with one round of
// independent global loads (one global latency per chunk instead of one
// per step), then runs the chunk's steps out of shared memory with no
// barrier between them: r_t[i], k_t[i], exp(lw_t)[i] are read by every
// thread at the same address (a broadcast).  Each step's dot product
// r_t . (...) is split over two accumulators to halve the dependent FMA
// chain.  T needs no chunk that divides it.  No atomics: the same inputs
// give the same bits on every run.  The chunked parallel form (a later
// PR's work) would turn the serial chain into matrix products.
// The wrapper (kernels/ops.py) allocates o; the C entry points launch on
// the caller's stream and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

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

}  // namespace

extern "C" {

// r, k, v, lw, o: contiguous (n_b, n_t, n_h, n_k) with r/k/v/o f32 and lw
// f32; u: contiguous (n_h, n_k) f32.  n_k in {8, 16, 32, 64}.
int wkv6_f32(const void* r, const void* k, const void* v, const void* lw,
             const void* u, void* o, int n_b, int n_t, int n_h, int n_k,
             void* stream) {
  return launch_wkv6<float>(r, k, v, lw, u, o, n_b, n_t, n_h, n_k,
                            static_cast<cudaStream_t>(stream));
}

// The same with r, k, v, u and o in bf16; lw stays f32, the state f32.
int wkv6_bf16(const void* r, const void* k, const void* v, const void* lw,
              const void* u, void* o, int n_b, int n_t, int n_h, int n_k,
              void* stream) {
  return launch_wkv6<__nv_bfloat16>(r, k, v, lw, u, o, n_b, n_t, n_h, n_k,
                                    static_cast<cudaStream_t>(stream));
}

}  // extern "C"

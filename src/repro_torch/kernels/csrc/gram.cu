// Fused G = XᵀX and r = Xᵀy in f32 for a tall, narrow X (ANM regression,
// paper eq. 4), for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/gram.py::gram (_gram_kernel), the Pallas TPU
// kernel reached from regression.fit_quadratic through kernels/ops.py::gram.
//
// What bounds it: at the main path's shape (m = 1000 rows, c = 45 columns,
// f32) the work is about 184 KB read (0.06 us at 3.35 TB/s) and 2.2 MFLOP
// (0.03 us at 67 TFLOP/s f32).  Both are far below the few microseconds a
// launch costs, so it is bound by latency, not bytes or FLOPs: two
// launches, and inside pass 1 the shared-memory latency of each thread's
// serial FMA chain with only 16 CTAs in flight (about 10 us per call on
// an H100 SXM at 700 W).
//
// Design.  The TPU kernel walks row blocks on a sequential grid and carries
// G in VMEM from block to block; on this card that would be one block on
// one SM of 132.  Instead:
//   pass 1  one CTA per contiguous range of ROWS rows.  The CTA stages its
//           rows of X and y in shared memory (bf16 converted to f32 on
//           load), then each thread sums a share of the c(c+1)/2 upper-
//           triangle entries and the c entries of r over those rows, with
//           f32 FMA (no TF32), and writes them to its row of a scratch
//           buffer (n_cta, c(c+1)/2 + c).
//   pass 2  one thread per entry sums the partials over the CTAs in a
//           fixed order and mirrors the upper triangle into the full c x c.
// No atomics: the same inputs give the same bits on every run, which the
// port's sync == pipelined and restored == uninterrupted contracts need.
// Any c up to kMaxCols is taken, with dynamic shared memory above 48 KB.
// The wrapper (kernels/ops.py) allocates every buffer; the C entry points
// launch on the caller's stream and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Entries of the packed upper triangle (i <= j, row-major) before row i.
__device__ __forceinline__ int tri_offset(int i, int c) {
  return i * c - (i * (i - 1)) / 2;
}

// Packed upper-triangle entry e -> (i, j): a float estimate of the row,
// corrected to the exact integer answer.
__device__ __forceinline__ void tri_index(int e, int c, int* i_out,
                                          int* j_out) {
  const float b = 2.0f * c + 1.0f;
  int i = static_cast<int>((b - sqrtf(b * b - 8.0f * e)) * 0.5f);
  i = max(0, min(i, c - 1));
  while (i > 0 && tri_offset(i, c) > e) --i;
  while (i + 1 < c && tri_offset(i + 1, c) <= e) ++i;
  *i_out = i;
  *j_out = i + (e - tri_offset(i, c));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gram_partial_kernel(const T* __restrict__ x, const T* __restrict__ y, int m,
                    int c, int rows_per_cta, float* __restrict__ partial) {
  extern __shared__ float smem[];
  float* xs = smem;                                 // rows_per_cta * c
  float* ys = smem + rows_per_cta * c;              // rows_per_cta
  const int row0 = blockIdx.x * rows_per_cta;
  const int rows = min(rows_per_cta, m - row0);
  const T* xb = x + static_cast<size_t>(row0) * c;
  for (int t = threadIdx.x; t < rows * c; t += blockDim.x) {
    xs[t] = to_f32(xb[t]);
  }
  for (int t = threadIdx.x; t < rows; t += blockDim.x) {
    ys[t] = to_f32(y[row0 + t]);
  }
  __syncthreads();

  const int tri = c * (c + 1) / 2;
  const int width = tri + c;
  float* out = partial + static_cast<size_t>(blockIdx.x) * width;
  for (int e = threadIdx.x; e < width; e += blockDim.x) {
    float acc = 0.0f;
    if (e < tri) {
      int i, j;
      tri_index(e, c, &i, &j);
      for (int k = 0; k < rows; ++k) {
        acc = fmaf(xs[k * c + i], xs[k * c + j], acc);
      }
    } else {
      const int i = e - tri;
      for (int k = 0; k < rows; ++k) {
        acc = fmaf(xs[k * c + i], ys[k], acc);
      }
    }
    out[e] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
gram_reduce_kernel(const float* __restrict__ partial, int n_cta, int c,
                   float* __restrict__ g, float* __restrict__ r) {
  const int tri = c * (c + 1) / 2;
  const int width = tri + c;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= width) return;
  float acc = 0.0f;
  for (int b = 0; b < n_cta; ++b) {               // fixed CTA order
    acc += partial[static_cast<size_t>(b) * width + e];
  }
  if (e < tri) {
    int i, j;
    tri_index(e, c, &i, &j);
    g[i * c + j] = acc;
    g[j * c + i] = acc;
  } else {
    r[e - tri] = acc;
  }
}

template <typename T>
int launch_gram(const void* x, const void* y, int m, int c, int rows_per_cta,
                void* partial, void* g, void* r, cudaStream_t stream) {
  if (m < 1 || c < 1 || c > kMaxCols || rows_per_cta < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_cta = (m + rows_per_cta - 1) / rows_per_cta;
  const size_t smem =
      (static_cast<size_t>(rows_per_cta) * c + rows_per_cta) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gram_partial_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gram_partial_kernel<T><<<n_cta, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), m, c, rows_per_cta,
      static_cast<float*>(partial));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int width = c * (c + 1) / 2 + c;
  gram_reduce_kernel<<<(width + kThreads - 1) / kThreads, kThreads, 0,
                       stream>>>(static_cast<const float*>(partial), n_cta, c,
                                 static_cast<float*>(g),
                                 static_cast<float*>(r));
  err = cudaGetLastError();
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// x: (m, c) f32, y: (m,) f32, row-major and contiguous.  partial holds
// ceil(m / rows_per_cta) * (c(c+1)/2 + c) floats; g (c, c) and r (c,) f32.
int gram_f32(const void* x, const void* y, int m, int c, int rows_per_cta,
             void* partial, void* g, void* r, void* stream) {
  return launch_gram<float>(x, y, m, c, rows_per_cta, partial, g, r,
                            static_cast<cudaStream_t>(stream));
}

// The same with x and y in bf16; sums stay f32.
int gram_bf16(const void* x, const void* y, int m, int c, int rows_per_cta,
              void* partial, void* g, void* r, void* stream) {
  return launch_gram<__nv_bfloat16>(x, y, m, c, rows_per_cta, partial, g, r,
                                    static_cast<cudaStream_t>(stream));
}

}  // extern "C"

// Row means of a contiguous (k, N) f32 matrix, each row summed in one fixed
// order, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference takes these means with jnp.mean
// inside the SDSS likelihood (src/repro/data/sdss.py::log_likelihood).  It
// is the port's own kernel, for one contract of the reference: a lane's
// fitness is a function of its own bytes alone, whatever the width of the
// bucket it is evaluated in, its place there and the other lanes beside it
// (coalesced == solo, restored == uninterrupted, warm cache == cold).  A
// library reduction picks its split of a row across threads and blocks
// from the whole tensor's shape, so the same row may be summed in another
// order in a bucket of 8 than in one of 1024; here the order is fixed.
//
// What bounds it.  Bytes: every element is read once (at (1000, 100000),
// 400 MB, 0.119 ms at 3.35 TB/s).  The adds are few beside them.
//
// Design.  One CTA of kThreads threads per row.  Thread t takes the row's
// float4s t, t + kThreads, t + 2 kThreads, ... and adds their four lanes
// into four f64 sums, one per lane, in that order; where N % 4 != 0 the
// last, ragged float4 goes to the thread whose turn it is.  The four sums
// are added lane 0 + 1, + 2, + 3, then the threads' sums in a fixed tree
// (sum t takes sum t + s, for s = kThreads / 2, ..., 1), and the total is
// divided by N in f64 and rounded once to f32.  Rows whose start is not 16-byte aligned
// are read as scalars in the same order, so the result depends only on
// the row's bytes and N.  The f64 sums lose nothing a f32 reader sees: the
// mean is the f64 mean rounded.  No atomics, no scratch in HBM.
// kernels/ref.py::row_mean_ref repeats this order in torch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
row_mean_kernel(const float* __restrict__ x, long long n,
                float* __restrict__ out) {
  __shared__ double sums[kThreads];
  const int t = threadIdx.x;
  const float* row = x + static_cast<long long>(blockIdx.x) * n;
  const long long quads = n / 4;
  double a0 = 0.0, a1 = 0.0, a2 = 0.0, a3 = 0.0;
  if ((reinterpret_cast<uintptr_t>(row) & 15) == 0) {
    const float4* row4 = reinterpret_cast<const float4*>(row);
#pragma unroll 4
    for (long long q = t; q < quads; q += kThreads) {
      const float4 v = __ldg(row4 + q);
      a0 += v.x;
      a1 += v.y;
      a2 += v.z;
      a3 += v.w;
    }
  } else {
#pragma unroll 4
    for (long long q = t; q < quads; q += kThreads) {
      const float* p = row + 4 * q;
      a0 += __ldg(p);
      a1 += __ldg(p + 1);
      a2 += __ldg(p + 2);
      a3 += __ldg(p + 3);
    }
  }
  if (t == quads % kThreads) {          // the ragged float4, in its turn
    const long long b = 4 * quads;
    if (b < n) a0 += __ldg(row + b);
    if (b + 1 < n) a1 += __ldg(row + b + 1);
    if (b + 2 < n) a2 += __ldg(row + b + 2);
  }
  sums[t] = ((a0 + a1) + a2) + a3;
  __syncthreads();
#pragma unroll
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s) sums[t] = sums[t] + sums[t + s];
    __syncthreads();
  }
  if (t == 0) {
    out[blockIdx.x] =
        __double2float_rn(__ddiv_rn(sums[0], static_cast<double>(n)));
  }
}

}  // namespace

extern "C" {

// x: (k, n) f32, row-major and contiguous; out: (k,) f32.  One CTA per
// row on `stream`; returns cudaGetLastError().
int row_mean_f32(const void* x, long long k, long long n, void* out,
                 void* stream) {
  if (k < 1 || k > 0x7fffffffLL || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  row_mean_kernel<<<static_cast<unsigned>(k), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

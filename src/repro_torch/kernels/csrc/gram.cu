// Fused G = XᵀX and r = Xᵀy in f32 for a tall, narrow X (ANM regression,
// paper eq. 4), for Hopper (sm_90a): one launch of one thread-block
// cluster.
//
// Replaces: src/repro/kernels/gram.py::gram (_gram_kernel), the Pallas TPU
// kernel reached from regression.fit_quadratic through kernels/ops.py::gram.
//
// What bounds it.  At the main path's shape (m = 1000 rows, c = 45
// columns, f32) the work is 192 KB moved (0.06 us at 3.35 TB/s) and 2.2
// MFLOP (0.03 us at 67 TFLOP/s f32).  No kernel gets near either: the
// floor is a launch, one round trip to DRAM for the rows and one to
// another SM's shared memory for the partial sums, a few microseconds.
// At m = 100,000 X is 18 MB (a ~5.5 us bytes bound); one cluster of 16
// SMs is then bound by its own f32 FMA issue and shared-memory reads, an
// eighth of the card.
//
// Design.  y is column c of the augmented matrix X~ = [X | y] (C = c + 1
// columns); the kernel sums the upper triangle of X~ᵀX~, whose leading
// c x c block is G (written to both halves, so G is exactly symmetric)
// and whose last column holds r.
//   tiles   the triangle is covered by square tiles (bi <= bj) of kTile x
//           kTile sums, X~'s columns padded to a multiple of kTile (4 or
//           8, chosen by the caller).  The nt(nt+1)/2 tiles are folded
//           onto a rectangle of nt/2 + 1 rows by nt columns: slot (r, q) is
//           tile (r, q) for q >= r, else tile (nt - r, nt - r + q); for even
//           nt the second half of the last row is empty.  A thread holds
//           one tile's sums in registers and, per staged row, reads kTile +
//           kTile values as float4 loads from shared memory and issues
//           kTile² independent FMAs (f32 only: no TF32, no tensor cores).
//           With fewer slots than threads, `groups` copies of the slot map,
//           each a whole number of warps, take interleaved rows (row k of
//           a stage goes to group k mod groups); with more slots than
//           threads, the rows are walked once per 256 slots (`passes`).
//   rows    rank q of the cluster takes m / n rows, one more for the first
//           m % n ranks.  It stages them in shared memory `stage_rows`
//           rows at a time, two stages deep: f32 by cp.async, in flight
//           while the previous stage is summed; bf16 widened to f32 on the
//           way.  Where all of a rank's rows fit one stage they are staged
//           once for every pass.  A rank with no rows contributes zeros.
//   reduce  slot s is owned by rank s mod n.  Each rank's sums of a slot
//           (first added over its groups in order, through shared memory,
//           where there are several) go into the owner's shared memory by
//           st.async through the cluster's distributed shared memory, one
//           row of `recv` per source rank, every store counted in bytes on
//           the owner's mbarrier.  Once all its bytes have arrived, a rank
//           adds its slots' sums over ranks 0, 1, ..., n - 1 in that order
//           and writes them into G and r.  A cluster barrier, arrived at
//           once each rank has set its mbarrier and waited on before the
//           first remote store, makes sure every rank is there to receive.
// No scratch memory in HBM and no atomics: the same inputs and arguments
// give the same bits on every run, which the port's sync == pipelined and
// restored == uninterrupted contracts need.  The wrapper (kernels/ops.py)
// allocates G and r and passes the cluster size, the rows per stage and
// the tile side; the C entry points launch on the caller's stream and
// return cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 256;
constexpr int kStageElems = 8192;    // most elements of [X | y] in a stage
constexpr int kMaxCluster = 16;
constexpr int kMaxGroups = 8;
constexpr int kMaxDevices = 64;

// One element into shared memory as f32: f32 by cp.async, bf16 widened.
__device__ __forceinline__ void copy_f32(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy_f32(float* dst,
                                         const __nv_bfloat16* src) {
  *dst = __bfloat162float(*src);
}

// The shared::cluster address of ptr (this CTA's shared memory) in rank
// `rank`'s shared memory.
__device__ __forceinline__ uint32_t remote(const void* ptr, int rank) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  asm volatile("mapa.shared::cluster.u32 %0, %0, %1;"
               : "+r"(addr)
               : "r"(rank));
  return addr;
}

// Four floats into another rank's shared memory at `to`, counted as 16
// bytes arrived on that rank's barrier at `bar`.
__device__ __forceinline__ void store_async(uint32_t to, float a, float b,
                                            float c, float d, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
      "[%0], {%1, %2, %3, %4}, [%5];" ::"r"(to),
      "f"(a), "f"(b), "f"(c), "f"(d), "r"(bar)
      : "memory");
}

// Everything derived from c, the cluster size and the tile side, the same
// in every CTA and on the host.
struct Shape {
  int cols;      // C = c + 1: X~'s columns
  int pitch;     // C rounded up to kTile: a staged row's floats
  int nt;        // tiles per side
  int slots;     // (nt / 2 + 1) * nt folded tile slots
  int stride;    // threads per group: slots rounded up to a warp
  int groups;    // copies of the slot map over interleaved rows
  int passes;    // walks over the rows, one slot per thread each
  int owned;     // most slots a rank owns: ceil(slots / n)
};

template <int kTile>
__host__ __device__ __forceinline__ Shape make_shape(int c, int n) {
  Shape s;
  s.cols = c + 1;
  s.pitch = (s.cols + kTile - 1) / kTile * kTile;
  s.nt = s.pitch / kTile;
  s.slots = (s.nt / 2 + 1) * s.nt;
  s.stride = (s.slots + 31) / 32 * 32;
  const int fit = kThreads / s.stride;
  s.groups = fit < 1 ? 1 : (fit > kMaxGroups ? kMaxGroups : fit);
  s.passes = (s.slots + kThreads - 1) / kThreads;
  s.owned = (s.slots + n - 1) / n;
  return s;
}

// Folded slot -> tile (bi, bj) with bi <= bj; false for the empty half row.
__host__ __device__ __forceinline__ bool slot_tile(int s, int nt, int* bi,
                                                   int* bj) {
  const int r = s / nt;
  const int q = s - r * nt;
  if (q >= r) {
    *bi = r;
    *bj = q;
    return true;
  }
  *bi = nt - r;
  *bj = nt - r + q;
  return nt - r > r;
}

// Slots below b that rank q of n owns (those s with s mod n == q).
__device__ __forceinline__ int owned_below(int b, int q, int n) {
  return b > q ? (b - q + n - 1) / n : 0;
}

// Whether folded slot s is a tile: below `slots` and not in the empty half
// of the last row (even nt).
__device__ __forceinline__ bool slot_exists(int s, const Shape& sh) {
  const int half = sh.nt / 2;
  return s < sh.slots &&
         (sh.nt % 2 || s < half * sh.nt || s >= half * sh.nt + half);
}

// Rows [lo, lo + count) of rank q of n: m / n each, one more for the first
// m % n ranks.
__device__ __forceinline__ void rank_rows(int m, int q, int n, int* lo,
                                          int* count) {
  const int base = m / n;
  const int extra = m - base * n;
  *lo = q * base + min(q, extra);
  *count = base + (q < extra ? 1 : 0);
}

template <typename T, int kTile>
__global__ void __launch_bounds__(kThreads, 1)
gram_cluster_kernel(const T* __restrict__ x, const T* __restrict__ y, int m,
                    int c, int stage_rows, float* __restrict__ g_out,
                    float* __restrict__ r_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // arrived: completes once every byte this rank owns has been stored
  uint64_t* arrived = reinterpret_cast<uint64_t*>(smem_raw);
  float* smem = reinterpret_cast<float*>(smem_raw + 16);
  cg::cluster_group cluster = cg::this_cluster();
  const int n_rank = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const Shape sh = make_shape<kTile>(c, n_rank);
  const int tid = threadIdx.x;
  const int rows_max = stage_rows;
  constexpr int kSums = kTile * kTile;
  // recv[(q * owned + l) * kSums + e]: rank q's sum e of this rank's l-th
  // slot (slot rank + l * n); part: every group's sums of every slot, where
  // there is more than one group
  float* recv = smem + 2 * rows_max * sh.pitch;
  float* part = recv + n_rank * sh.owned * kSums;

  int row_lo, n_rows;
  rank_rows(m, rank, n_rank, &row_lo, &n_rows);
  const int n_stages = (n_rows + rows_max - 1) / rows_max;
  const bool resident = n_stages <= 1;      // staged once for every pass

  // Stage st of this rank's rows into buf: X's rows of a stage are
  // contiguous, so element f = k * c + j goes to buf[k * pitch + j], with
  // (k, j) stepped from f = tid without a division.  f32 is copied with
  // cp.async (nothing held in registers, the copy in flight while the
  // previous stage is summed); bf16 is widened on the way, synchronously.
  const int k0 = tid / c;
  const int j0 = tid - k0 * c;
  const int step_k = kThreads / c;
  const int step_j = kThreads - step_k * c;
  auto stage = [&](int st, float* buf) {
    const int rows = min(rows_max, n_rows - st * rows_max);
    const long long row0 = row_lo + static_cast<long long>(st) * rows_max;
    const T* xs = x + row0 * c;
    const int n_x = rows * c;
    int k = k0, j = j0;
#pragma unroll 4
    for (int f = tid; f < n_x; f += kThreads) {
      copy_f32(buf + k * sh.pitch + j, xs + f);
      j += step_j;
      k += step_k;
      if (j >= c) {
        j -= c;
        ++k;
      }
    }
    if (tid < rows) copy_f32(buf + tid * sh.pitch + c, y + row0 + tid);
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  if (n_stages > 0) stage(0, smem);         // in flight during the set-up

  const uint32_t arrived_at =
      static_cast<uint32_t>(__cvta_generic_to_shared(arrived));
  if (tid == 0) {
    // this rank's slots, less those of the empty half row (even nt)
    int owned = owned_below(sh.slots, rank, n_rank);
    if (sh.nt % 2 == 0) {
      const int half = sh.nt / 2;
      owned -= owned_below(half * sh.nt + half, rank, n_rank) -
               owned_below(half * sh.nt, rank, n_rank);
    }
    const int bytes = n_rank * owned * kSums * 4;
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(arrived_at)
                 : "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
            arrived_at),
        "r"(bytes)
        : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // Every rank has started, and its barrier is set, before any stores
  // into its memory (waited on before the first of them).
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");

  // Padding columns stay zero in both stage buffers.
  for (int k = tid; k < 2 * rows_max; k += kThreads) {
    for (int j = sh.cols; j < sh.pitch; ++j) smem[k * sh.pitch + j] = 0.0f;
  }

  const int n_seq = sh.passes * n_stages;   // (pass, stage) in order
  for (int pass = 0; pass < sh.passes; ++pass) {
    int group, slot;
    if (sh.passes == 1) {
      group = tid / sh.stride;
      slot = tid - group * sh.stride;
    } else {
      group = 0;
      slot = pass * kThreads + tid;
    }
    int bi = 0, bj = 0;
    const bool mine = group < sh.groups && slot < sh.slots &&
                      slot_tile(slot, sh.nt, &bi, &bj);
    float acc[kSums];
#pragma unroll
    for (int e = 0; e < kSums; ++e) acc[e] = 0.0f;

    for (int st = 0; st < n_stages; ++st) {
      const int seq = pass * n_stages + st;
      const float* buf =
          smem + (resident ? 0 : (seq & 1) * rows_max * sh.pitch);
      const int rows = min(rows_max, n_rows - st * rows_max);
      if (!resident || pass == 0) {
        asm volatile("cp.async.wait_all;" ::: "memory");
        __syncthreads();
        if (!resident && seq + 1 < n_seq) {  // in flight while this one sums
          stage((seq + 1) % n_stages,
                smem + ((seq + 1) & 1) * rows_max * sh.pitch);
        }
      }
      if (!mine) continue;
      const float* pi = buf + kTile * bi;
      const float* pj = buf + kTile * bj;
#pragma unroll(kTile == 4 ? 4 : 2)
      for (int k = group; k < rows; k += sh.groups) {
        float av[kTile], bv[kTile];
#pragma unroll
        for (int h = 0; h < kTile; h += 4) {
          const float4 a =
              *reinterpret_cast<const float4*>(pi + k * sh.pitch + h);
          const float4 b =
              *reinterpret_cast<const float4*>(pj + k * sh.pitch + h);
          av[h] = a.x;
          av[h + 1] = a.y;
          av[h + 2] = a.z;
          av[h + 3] = a.w;
          bv[h] = b.x;
          bv[h + 1] = b.y;
          bv[h + 2] = b.z;
          bv[h + 3] = b.w;
        }
#pragma unroll
        for (int u = 0; u < kTile; ++u) {
#pragma unroll
          for (int v = 0; v < kTile; ++v) {
            acc[u * kTile + v] = fmaf(av[u], bv[v], acc[u * kTile + v]);
          }
        }
      }
    }

    if (pass == 0) {
      asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    }
    if (sh.groups == 1) {
      // One group: this thread's sums go to the slot's owner as they are.
      if (mine) {
        const uint32_t to = remote(
            recv + (rank * sh.owned + slot / n_rank) * kSums, slot % n_rank);
        const uint32_t bar = remote(arrived, slot % n_rank);
#pragma unroll
        for (int e = 0; e < kSums; e += 4) {
          store_async(to + 4 * e, acc[e], acc[e + 1], acc[e + 2], acc[e + 3],
                      bar);
        }
      }
    } else {
      // Groups: summed here in order, then each sum to its slot's owner.
      // part as float4s [(group * kQuads + e / 4) * slots + slot]: the
      // lanes of a warp store and load neighbouring float4s, free of bank
      // conflicts
      constexpr int kQuads = kSums / 4;     // float4s of a slot's sums
      float4* part4 = reinterpret_cast<float4*>(part);
      if (mine) {
#pragma unroll
        for (int e = 0; e < kSums; e += 4) {
          part4[(group * kQuads + e / 4) * sh.slots + slot] =
              make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
        }
      }
      __syncthreads();
      // Owner-major: thread tid pushes to rank tid % n, so the remote
      // addresses are mapped once and no item needs a division.
      const int per_owner = kThreads / n_rank;
      const int owner = tid % n_rank;
      const int first = tid / n_rank;
      if (first < per_owner) {
        const uint32_t to = remote(recv + rank * sh.owned * kSums, owner);
        const uint32_t bar = remote(arrived, owner);
        for (int i = first; i < sh.owned * kQuads; i += per_owner) {
          const int l = i / kQuads;
          const int e4 = i - l * kQuads;
          const int s = owner + l * n_rank;
          if (!slot_exists(s, sh)) continue;
          float4 v[kMaxGroups];
#pragma unroll
          for (int g = 0; g < kMaxGroups; ++g) {
            if (g < sh.groups) {
              v[g] = part4[(g * kQuads + e4) * sh.slots + s];
            }
          }
          float4 sum = v[0];
#pragma unroll
          for (int g = 1; g < kMaxGroups; ++g) {
            if (g < sh.groups) {
              sum.x += v[g].x;
              sum.y += v[g].y;
              sum.z += v[g].z;
              sum.w += v[g].w;
            }
          }
          store_async(to + 4 * (l * kSums + 4 * e4), sum.x, sum.y, sum.z,
                      sum.w, bar);
        }
      }
    }
  }
  // Every rank's sums of this rank's slots have arrived.
  for (uint32_t done = 0; !done;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(arrived_at)
        : "memory");
  }

  // This rank's slots: each sum over ranks 0, 1, ..., n - 1 in order.
  for (int t = tid; t < sh.owned * kSums; t += kThreads) {
    const int l = t / kSums;
    const int e = t - l * kSums;
    const int slot = rank + l * n_rank;
    int bi, bj;
    if (slot >= sh.slots || !slot_tile(slot, sh.nt, &bi, &bj)) continue;
    const int i = kTile * bi + e / kTile;
    const int j = kTile * bj + e % kTile;
    if (i > j || j > c || i >= c) continue;
    float v[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {
      if (q < n_rank) v[q] = recv[(q * sh.owned + l) * kSums + e];
    }
    float sum = v[0];
#pragma unroll
    for (int q = 1; q < kMaxCluster; ++q) {
      if (q < n_rank) sum += v[q];
    }
    if (j < c) {
      g_out[i * c + j] = sum;
      g_out[j * c + i] = sum;
    } else {
      r_out[i] = sum;
    }
  }
}

// Dynamic shared memory of one CTA: its barrier (16 bytes), two stages,
// the sums it owns and, with more than one group, every group's sums.
template <int kTile>
size_t smem_bytes(int c, int stage_rows, int n) {
  const Shape sh = make_shape<kTile>(c, n);
  const size_t part =
      sh.groups > 1 ? static_cast<size_t>(sh.groups) * sh.slots : 0;
  return 16 + (2 * static_cast<size_t>(stage_rows) * sh.pitch +
               (static_cast<size_t>(n) * sh.owned + part) * kTile * kTile) *
                  sizeof(float);
}

template <typename T, int kTile>
cudaError_t configure() {
  // Once per device: the largest dynamic shared memory a block may take,
  // and clusters above the portable 8 CTAs.
  static bool done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(gram_cluster_kernel<T, kTile>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(gram_cluster_kernel<T, kTile>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices) done[dev] = true;
  return cudaSuccess;
}

bool valid_args(int c, int cluster, int stage_rows, int tile) {
  return c >= 1 && c <= kMaxCols && cluster >= 1 && cluster <= kMaxCluster &&
         stage_rows >= 1 && stage_rows <= kThreads &&
         stage_rows * (c + 1) <= kStageElems && (tile == 4 || tile == 8);
}

// The launch configuration of one cluster of `cluster` CTAs.
struct Launch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  Launch(int cluster, size_t smem, cudaStream_t stream) : cfg() {
    cfg.gridDim = dim3(cluster, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <typename T, int kTile>
int launch_gram(const void* x, const void* y, int m, int c, int cluster,
                int stage_rows, void* g, void* r, cudaStream_t stream) {
  cudaError_t err = configure<T, kTile>();
  if (err != cudaSuccess) return static_cast<int>(err);
  Launch l(cluster, smem_bytes<kTile>(c, stage_rows, cluster), stream);
  err = cudaLaunchKernelEx(&l.cfg, gram_cluster_kernel<T, kTile>,
                           static_cast<const T*>(x), static_cast<const T*>(y),
                           m, c, stage_rows, static_cast<float*>(g),
                           static_cast<float*>(r));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* y, int m, int c, int cluster,
           int stage_rows, int tile, void* g, void* r, void* stream) {
  if (m < 1 || !valid_args(c, cluster, stage_rows, tile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  return tile == 4
             ? launch_gram<T, 4>(x, y, m, c, cluster, stage_rows, g, r, s)
             : launch_gram<T, 8>(x, y, m, c, cluster, stage_rows, g, r, s);
}

}  // namespace

extern "C" {

// x: (m, c) f32, y: (m,) f32, row-major and contiguous; g (c, c) and r
// (c,) f32.  One cluster of `cluster` CTAs (1-16), `stage_rows` rows per
// stage (at most 256, stage_rows * (c + 1) <= 8192), tiles of `tile` x
// `tile` sums per thread (4 or 8).
int gram_f32(const void* x, const void* y, int m, int c, int cluster,
             int stage_rows, int tile, void* g, void* r, void* stream) {
  return launch<float>(x, y, m, c, cluster, stage_rows, tile, g, r, stream);
}

// The same with x and y in bf16; sums stay f32.
int gram_bf16(const void* x, const void* y, int m, int c, int cluster,
              int stage_rows, int tile, void* g, void* r, void* stream) {
  return launch<__nv_bfloat16>(x, y, m, c, cluster, stage_rows, tile, g, r,
                               stream);
}

// How many clusters of `cluster` CTAs fit on the current device at once
// for these arguments (cudaOccupancyMaxActiveClusters, f32); 0 where none
// fits, a negative CUDA error code where the query fails.
int gram_max_active_clusters(int c, int cluster, int stage_rows, int tile) {
  if (!valid_args(c, cluster, stage_rows, tile)) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = tile == 4 ? smem_bytes<4>(c, stage_rows, cluster)
                                : smem_bytes<8>(c, stage_rows, cluster);
  cudaError_t err =
      tile == 4 ? configure<float, 4>() : configure<float, 8>();
  if (err != cudaSuccess) return -static_cast<int>(err);
  Launch l(cluster, smem, nullptr);
  int n = 0;
  err = tile == 4 ? cudaOccupancyMaxActiveClusters(
                        &n, gram_cluster_kernel<float, 4>, &l.cfg)
                  : cudaOccupancyMaxActiveClusters(
                        &n, gram_cluster_kernel<float, 8>, &l.cfg);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return n;
}

}  // extern "C"

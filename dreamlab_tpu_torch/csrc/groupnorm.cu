// GroupNorm (+SiLU) over NHWC for Hopper (sm_90a): one launch per call.
//
// Replaces the Pallas TPU kernels of dreamlab_tpu/ops/groupnorm.py::
// fused_group_norm_silu: _stats_kernel (per-tile, per-channel sums carried
// over the sequential grid) and _apply_kernel (y = x*a + b, then SiLU). On
// the main path both run in one launch of gn_cluster_kernel; the K3 entry
// point alone (coefficients given) is gn_apply_kernel.
//
// What it computes: x [B, HW, C] (channels contiguous) -> per-(B, C)
// coefficients a = gamma * rsqrt(var_g + eps), b = beta - mean_g * a, then
// y = x*a + b (optionally SiLU) in x's dtype. Statistics are fp32.
//
// Variance: the Pallas kernel takes E[x^2] - mean^2, which loses digits when
// |mean| >> std. Here each thread keeps per-channel (mean, M2) by Welford's
// update; within a block they are merged into groups with Chan's formula, and
// across the blocks of a cluster as mean = sum(n_r m_r) / n and
// M2 = sum(M2_r + n_r (m_r - mean)^2), so the result matches the two-pass
// mean((x - mean)^2) of dreamlab_tpu/models/layers.py::group_norm.
//
// What bounds it on this card: about ten operations per element, so bytes:
// x read once and y written once, 0.706 ms per 512x512 request at 3.35 TB/s
// (the UNet's 180 calls 0.160 ms, under 1 us each, so latency; the VAE's 29
// calls 0.546 ms, its largest rows 67 and 134 MB, above the 50 MB L2).
//
// What this design does about it: one launch per call, with no global
// scratch and no finalize pass. A thread block cluster (Hopper) owns one
// (batch row, channel slab): the slab is a run of whole groups at least 64
// bytes wide, so each row of it is whole 16-byte vectors (32-byte slabs
// measured slower: more blocks, but half-used DRAM bursts). The cluster's
// blocks take its rows in turn (row r to rank r mod cluster), so the
// clusters of all slabs sweep the same rows together. Each block merges its
// threads' partials per group in shared memory (every warp of the block
// takes a share of the merges; fixed order, shuffle trees), pushes its
// per-group (mean, M2) into every peer's shared memory (distributed shared
// memory), and after one cluster barrier every block sums all ranks'
// partials in the same fixed order: identical statistics in every block and
// every run, and no float atomics. It folds gamma, beta into per-channel
// a, b and writes y, every access a 16-byte vector along the channels, held
// as raw 16-byte words until used, four rows in flight per thread. A block
// whose rows fit in 96 KB keeps them in shared memory from the first pass
// (every UNet call and the VAE's calls up to 128^2 x 512), so x is read once;
// the larger VAE rows (256^2 x 512 and up, above the 50 MB L2) are read
// again, 1.5x the bytes bound. Small blocks run 128 threads (more fit on an
// SM, so a cluster of 16 is placed at once); the VAE's wide rows run 1024.
// Slab, cluster size, rows per block and threads depend on (HW, C, groups)
// only, never on B: a batch row is summed in the same order alone or in a
// batch.

#include <cooperative_groups.h>

#include <atomic>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kApplyThreads = 256;
constexpr int kUnroll = 4;  // rows each thread keeps in flight (8 and 16 measured slower)
constexpr int kMaxCluster = 16;  // "non-portable" above 8: Hopper allows 16

// y = silu(t) = t * sigmoid(t) with the fast exp and division: within a few
// fp32 ulps, far below a bf16 rounding (and the fp32 checks' 1e-5)
__device__ __forceinline__ float silu(float t) {
  return __fdividef(t, 1.f + __expf(-t));
}

// (n_a, mean_a, m2_a) <- the union with (n_b, mean_b, m2_b), Chan's formula
__device__ __forceinline__ void chan_merge(float& n_a, float& mean_a, float& m2_a,
                                           float n_b, float mean_b, float m2_b) {
  if (n_b == 0.f) return;
  const float n = n_a + n_b;
  const float f = __fdividef(n_b, n);
  const float delta = mean_b - mean_a;
  mean_a = fmaf(delta, f, mean_a);
  m2_a += m2_b + delta * delta * (n_a * f);
  n_a = n;
}

// The warp's total of v, in every lane (a fixed tree: the same sum each run).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One 16-byte vector of x as fp32 values.
__device__ __forceinline__ void unpack(const uint4& raw, float* out, const float*) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(const uint4& raw, float* out, const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Rows a block rank owns: rank, rank + csize, rank + 2 csize, ... below hw.
__device__ __forceinline__ int rows_of(int rank, int csize, int hw) {
  return rank < hw ? (hw - rank + csize - 1) / csize : 0;
}

// A block keeps its rows of x in shared memory between the two passes when
// they take at most this many bytes (every UNet call, the VAE's smaller
// ones); beyond it the apply pass reads them again.
constexpr int kKeepBytes = 96 * 1024;

// Shared memory of gn_cluster_kernel: the kept rows (16-byte aligned), then
// the fp32 statistics and coefficients.
__host__ __device__ inline int gn_tile_bytes(int rows, int slab, int elt) {
  const int64_t bytes = static_cast<int64_t>(rows) * slab * elt;
  return bytes <= kKeepBytes ? static_cast<int>(bytes) : 0;
}
__host__ __device__ inline int gn_smem_bytes(int rows, int slab, int elt, int threads,
                                             int row_groups, int slab_groups) {
  return gn_tile_bytes(rows, slab, elt) +
         4 * (2 * row_groups * slab + 2 * slab + 4 * slab_groups +
              2 * kMaxCluster * slab_groups +
              3 * (slab_groups > threads / 32 ? slab_groups : threads / 32));
}

// Phase 5 of gn_cluster_kernel: y = x*a + b (+SiLU) over a thread's rows
// r_first, r_first + rg, ... below nrows of its block (row r at
// xs + r * rstride, kept at s_x[r * nvec + cv] where there is a tile).
template <typename T>
__device__ __forceinline__ void apply_rows(const T* xs, T* ys, const uint4* s_x,
                                           const float* s_a, const float* s_b, int r_first,
                                           int nrows, int rg, int nvec, int cv, int64_t rstride,
                                           int tile, int silu_on) {
  constexpr int VEC = DlVec<T>::kN;
  float av[VEC], bv[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    av[e] = s_a[e];
    bv[e] = s_b[e];
  }
  for (int r = r_first; r < nrows; r += kUnroll * rg) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * rg < nrows) {
        raw[u] = tile ? s_x[(r + u * rg) * nvec + cv]
                      : *reinterpret_cast<const uint4*>(xs + (r + u * rg) * rstride);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * rg < nrows) {
        float xv[VEC];
        unpack(raw[u], xv, xs);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float t = fmaf(xv[e], av[e], bv[e]);
          xv[e] = silu_on ? silu(t) : t;
        }
        dl_store_vec(ys + (r + u * rg) * rstride, xv);
      }
    }
  }
}

// Split halves of a cluster barrier: a block arrives as it starts and waits
// before it first writes to a peer's shared memory (which must have started).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Grid (cluster * C / slab, 1, B), clusters of `cluster` blocks along x: one
// cluster per (batch row, slab), block rank r owning rows r, r + cluster, ...
// (at most `rows` of them). apply = 0 writes a, bb [B, C] instead of y.
// MAXT: the block size class, up to 256 threads or up to 1024 (which holds
// each thread to 64 registers).
template <typename T, int MAXT>
__global__ void __launch_bounds__(MAXT)
gn_cluster_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                  const T* __restrict__ beta, T* __restrict__ y, float* __restrict__ a,
                  float* __restrict__ bb, int hw, int c, int groups, int slab, int rows,
                  float eps, int silu_on, int apply) {
  constexpr int VEC = DlVec<T>::kN;
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int cgrp = c / groups;       // channels per group
  const int ngs = slab / cgrp;       // groups in the slab
  const int nvec = slab / VEC;       // vectors in a row of the slab
  const int rg = blockDim.x / nvec;  // row groups: threads that share a vector
  const int cv = threadIdx.x % nvec;
  const int rgi = threadIdx.x / nvec;
  const bool active = rgi < rg;
  const int c0 = (blockIdx.x / csize) * slab;
  // the block's rows, interleaved with its peers' (global row = r * csize +
  // rank), so that the clusters of all slabs sweep the same rows together
  const int nrows = rows_of(rank, csize, hw);
  const int64_t rstride = static_cast<int64_t>(csize) * c;
  const int tile = gn_tile_bytes(rows, slab, sizeof(T));

  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* s_x = reinterpret_cast<uint4*>(smem_raw);  // [rows][nvec] if kept (tile > 0)
  float* s_mean = reinterpret_cast<float*>(smem_raw + tile);  // [rg][slab]: per thread
  float* s_m2 = s_mean + rg * slab;    // [rg][slab]
  float* s_wpart = s_m2 + rg * slab;   // [ngs * wpg][3]: (n, mean, M2) per warp of a group
  float* s_part = s_wpart + 3 * max(ngs, static_cast<int>(blockDim.x) >> 5);  // [ngs][2]
  float* s_all = s_part + 2 * ngs;     // [csize][ngs][2]: every rank's s_part, pushed
  float* s_group = s_all + 2 * csize * ngs;  // [ngs][2]: group mean, rsqrt(var + eps)
  float* s_a = s_group + 2 * ngs;      // [slab]: gamma, then a
  float* s_b = s_a + slab;             // [slab]: beta, then b

  cluster_arrive();  // this block runs: its peers may write to it once they wait
  const int64_t row_base = static_cast<int64_t>(blockIdx.z) * hw;
  const T* xs = x + (row_base + rank) * c + c0 + cv * VEC;
  // gamma and beta now, so their loads overlap the first pass
  for (int ch = threadIdx.x; ch < slab; ch += blockDim.x) {
    s_a[ch] = dl_to_float(gamma[c0 + ch]);
    s_b[ch] = dl_to_float(beta[c0 + ch]);
  }

  // 1. per-thread Welford over the block's rows rgi, rgi + rg, ..., kept in
  //    shared memory as they pass where the tile fits
  if (active) {
    float mean[VEC], m2[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) mean[e] = m2[e] = 0.f;
    int count = 0;
    for (int r = rgi; r < nrows; r += kUnroll * rg) {
      uint4 raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + u * rg < nrows) {
          raw[u] = *reinterpret_cast<const uint4*>(xs + (r + u * rg) * rstride);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + u * rg < nrows) {
          if (tile) s_x[(r + u * rg) * nvec + cv] = raw[u];
          float xv[VEC];
          unpack(raw[u], xv, x);
          ++count;
          const float inv = __frcp_rn(static_cast<float>(count));
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float delta = xv[e] - mean[e];
            mean[e] = fmaf(delta, inv, mean[e]);
            m2[e] = fmaf(delta, xv[e] - mean[e], m2[e]);
          }
        }
      }
    }
#pragma unroll
    for (int e = 0; e < VEC; e += 4) {
      const int at = rgi * slab + cv * VEC + e;
      *reinterpret_cast<float4*>(s_mean + at) = make_float4(mean[e], mean[e + 1], mean[e + 2],
                                                            mean[e + 3]);
      *reinterpret_cast<float4*>(s_m2 + at) = make_float4(m2[e], m2[e + 1], m2[e + 2], m2[e + 3]);
    }
  }
  __syncthreads();

  // 2. `wpg` warps per group: each lane merges (Chan) its share of the
  //    group's (row group, channel) parts in a fixed order (row group ri holds
  //    q + (ri < rem) rows; only the first min(rg, nrows) hold any), a fixed
  //    shuffle tree merges the lanes, then the group's warps merge in order
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int q = nrows / rg;
  const int rem = nrows - q * rg;
  const int live = min(rg, nrows);
  const int wpg = max(1, nwarps / ngs);
  for (int w = warp; w < ngs * wpg; w += nwarps) {
    const int gi = w / wpg;
    float n_a = 0.f, mean_a = 0.f, m2_a = 0.f;
    // entry i = ri * cgrp + j, walked as i = (w % wpg) * 32 + lane + k * 32 * wpg
    const int first = (w % wpg) * 32 + lane;
    int ri = first / cgrp;
    int j = first - ri * cgrp;
    const int step_ri = 32 * wpg / cgrp;
    const int step_j = 32 * wpg - step_ri * cgrp;
    while (ri < live) {
      const int at = ri * slab + gi * cgrp + j;
      chan_merge(n_a, mean_a, m2_a, static_cast<float>(q + (ri < rem)), s_mean[at], s_m2[at]);
      ri += step_ri;
      j += step_j;
      if (j >= cgrp) {
        j -= cgrp;
        ++ri;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float n_b = __shfl_down_sync(0xffffffffu, n_a, off);
      const float mean_b = __shfl_down_sync(0xffffffffu, mean_a, off);
      const float m2_b = __shfl_down_sync(0xffffffffu, m2_a, off);
      if (lane + off < 32) chan_merge(n_a, mean_a, m2_a, n_b, mean_b, m2_b);
    }
    if (lane == 0) {
      s_wpart[3 * w] = n_a;
      s_wpart[3 * w + 1] = mean_a;
      s_wpart[3 * w + 2] = m2_a;
    }
  }
  __syncthreads();
  for (int gi = threadIdx.x; gi < ngs; gi += blockDim.x) {
    float n_a = 0.f, mean_a = 0.f, m2_a = 0.f;
    for (int w = gi * wpg; w < gi * wpg + wpg; ++w) {
      chan_merge(n_a, mean_a, m2_a, s_wpart[3 * w], s_wpart[3 * w + 1], s_wpart[3 * w + 2]);
    }
    s_part[2 * gi] = mean_a;
    s_part[2 * gi + 1] = m2_a;
  }
  __syncthreads();

  // 3. the block's partials pushed into every peer's s_all[rank] (distributed
  //    shared memory); after the cluster barrier each block holds all ranks'
  //    partials and sums them, one warp per group with lane r on rank r, over
  //    a fixed shuffle tree of the ranks
  cluster_wait();  // every peer has started
  for (int t = threadIdx.x; t < csize * ngs; t += blockDim.x) {
    const int peer = t / ngs;
    const int gi = t - peer * ngs;
    float* dst = cluster.map_shared_rank(s_all, peer) + 2 * (rank * ngs + gi);
    dst[0] = s_part[2 * gi];
    dst[1] = s_part[2 * gi + 1];
  }
  cluster.sync();  // every rank's partials are in every block
  const float n_group = static_cast<float>(hw) * cgrp;
  for (int gi = warp; gi < ngs; gi += nwarps) {
    float n_r = 0.f, mean_r = 0.f, m2_r = 0.f;
    if (lane < csize) {
      n_r = static_cast<float>(rows_of(lane, csize, hw)) * cgrp;
      mean_r = s_all[2 * (lane * ngs + gi)];
      m2_r = s_all[2 * (lane * ngs + gi) + 1];
    }
    const float mu = warp_sum(n_r * mean_r) / n_group;
    const float dm = mean_r - mu;
    const float m2 = warp_sum(fmaf(n_r * dm, dm, m2_r));
    if (lane == 0) {
      s_group[2 * gi] = mu;
      s_group[2 * gi + 1] = rsqrtf(m2 / n_group + eps);
    }
  }
  __syncthreads();

  // 4. gamma, beta folded into per-channel a, b
  for (int ch = threadIdx.x; ch < slab; ch += blockDim.x) {
    const int gi = ch / cgrp;
    const float av = s_a[ch] * s_group[2 * gi + 1];
    s_a[ch] = av;
    s_b[ch] -= s_group[2 * gi] * av;
  }
  __syncthreads();
  if (!apply) {
    if (rank == 0) {
      for (int ch = threadIdx.x; ch < slab; ch += blockDim.x) {
        a[blockIdx.z * static_cast<int64_t>(c) + c0 + ch] = s_a[ch];
        bb[blockIdx.z * static_cast<int64_t>(c) + c0 + ch] = s_b[ch];
      }
    }
  } else if (active) {
    apply_rows<T>(xs, y + (row_base + rank) * c + c0 + cv * VEC, s_x, s_a + cv * VEC,
                  s_b + cv * VEC, rgi, nrows, rg, nvec, cv, rstride, tile, silu_on);
  }
}

template <typename T>
__global__ void __launch_bounds__(kApplyThreads)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ bb, T* __restrict__ y,
                int64_t hw, int c, int silu_on) {
  constexpr int VEC = DlVec<T>::kN;
  const int b = blockIdx.y;
  const int64_t nvec = hw * c / VEC;
  const T* xb = x + static_cast<int64_t>(b) * hw * c;
  T* yb = y + static_cast<int64_t>(b) * hw * c;
  const float* ab = a + static_cast<int64_t>(b) * c;
  const float* bbb = bb + static_cast<int64_t>(b) * c;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < nvec; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int c0 = static_cast<int>((i * VEC) % c);
    float xv[VEC], av[VEC], bv[VEC], yv[VEC];
    dl_load_vec(xb + i * VEC, xv);
#pragma unroll
    for (int e = 0; e < VEC; e += 4) {
      dl_load_vec(ab + c0 + e, av + e);
      dl_load_vec(bbb + c0 + e, bv + e);
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float t = fmaf(xv[e], av[e], bv[e]);
      yv[e] = silu_on ? silu(t) : t;
    }
    dl_store_vec(yb + i * VEC, yv);
  }
}

// The kernel's dynamic shared-memory limit, raised as far as a call needs
// (kept per instance, so cudaFuncSetAttribute runs once per new maximum).
template <typename T, int MAXT>
cudaError_t allow_smem(size_t bytes) {
  static std::atomic<size_t> allowed{48 * 1024};
  if (bytes <= allowed.load()) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      gn_cluster_kernel<T, MAXT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) allowed.store(bytes);
  return err;
}

template <typename T, int MAXT>
cudaError_t allow_wide_clusters() {
  static std::atomic<bool> done{false};
  if (done.load()) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      gn_cluster_kernel<T, MAXT>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) done.store(true);
  return err;
}

template <typename T, int MAXT>
int launch_cluster(const void* x, const void* gamma, const void* beta, void* y, void* a,
                   void* bb, int b, int hw, int c, int groups, int slab, int cluster,
                   int rows, int threads, float eps, int silu, int apply,
                   cudaStream_t stream) {
  constexpr int VEC = DlVec<T>::kN;
  const size_t smem = static_cast<size_t>(gn_smem_bytes(
      rows, slab, sizeof(T), threads, threads / (slab / VEC), slab / (c / groups)));
  cudaError_t err = allow_smem<T, MAXT>(smem);
  if (err == cudaSuccess && cluster > 8) err = allow_wide_clusters<T, MAXT>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * (c / slab), 1, b);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, gn_cluster_kernel<T, MAXT>, static_cast<const T*>(x), static_cast<const T*>(gamma),
      static_cast<const T*>(beta), static_cast<T*>(y), static_cast<float*>(a),
      static_cast<float*>(bb), hw, c, groups, slab, rows, eps, silu, apply));
}

}  // namespace

// Each entry point returns the launch's CUDA error (cudaGetLastError() after
// it), or -1 for an unsupported dtype or geometry (the Python wrapper checks
// shapes, dtypes and the geometry first).

// One GroupNorm call: slab, cluster, rows and threads from
// dreamlab_tpu_torch/ops/groupnorm.py::geometry. apply = 1 writes y (a, bb
// unused); apply = 0 writes the coefficients a, bb [B, C] (y unused).
extern "C" int dl_gn_cluster(int device, const void* x, const void* gamma,
                             const void* beta, void* y, void* a, void* bb, int dtype,
                             int b, int hw, int c, int groups, int slab, int cluster,
                             int rows, int threads, float eps, int silu, int apply,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = dtype == kFloat32 ? 4 : 8;
  if (groups <= 0 || c % groups || slab <= 0 || c % slab || slab % vec ||
      slab % (c / groups) || cluster < 1 || cluster > kMaxCluster || threads > 1024 ||
      threads % 32 || threads < slab / vec) {
    return -1;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = -1;
#define DL_GN_LAUNCH(T, MAXT)                                                        \
  rc = launch_cluster<T, MAXT>(x, gamma, beta, y, a, bb, b, hw, c, groups, slab,    \
                               cluster, rows, threads, eps, silu, apply, st)
  if (dtype == kFloat32) {
    if (threads <= 256) DL_GN_LAUNCH(float, 256); else DL_GN_LAUNCH(float, 1024);
  } else if (dtype == kBFloat16) {
    if (threads <= 256) DL_GN_LAUNCH(__nv_bfloat16, 256); else DL_GN_LAUNCH(__nv_bfloat16, 1024);
  }
#undef DL_GN_LAUNCH
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dl_gn_apply(int device, const void* x, const void* a,
                           const void* bb, void* y, int dtype, int b,
                           int64_t hw, int c, int silu, int blocks,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks, b);
  if (dtype == kFloat32) {
    gn_apply_kernel<float><<<grid, kApplyThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(a),
        static_cast<const float*>(bb), static_cast<float*>(y), hw, c, silu);
  } else if (dtype == kBFloat16) {
    gn_apply_kernel<__nv_bfloat16><<<grid, kApplyThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(a),
        static_cast<const float*>(bb), static_cast<__nv_bfloat16*>(y), hw, c,
        silu);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

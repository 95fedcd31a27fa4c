// GroupNorm (+SiLU) over NHWC for Hopper (sm_90a), in three launches.
//
// Replaces the Pallas TPU kernels of dreamlab_tpu/ops/groupnorm.py::
// fused_group_norm_silu: _stats_kernel (per-tile, per-channel sums) with
// gn_stats_kernel + gn_finalize_kernel, and _apply_kernel (y = x*a + b, then
// SiLU) with gn_apply_kernel.
//
// What it computes: x [B, HW, C] (channels contiguous) -> per-(B, C)
// coefficients a = gamma * rsqrt(var_g + eps), b = beta - mean_g * a, then
// y = x*a + b (optionally SiLU) in x's dtype. Statistics are fp32.
//
// Variance: the Pallas kernel takes E[x^2] - mean^2, which loses digits when
// |mean| >> std. Here each tile keeps per-channel (mean, M2) by Welford's
// update, and tiles and channels are combined into groups with Chan's
// formula, so the result matches the two-pass mean((x - mean)^2) of
// dreamlab_tpu/models/layers.py::group_norm.
//
// What bounds it on this card: about one operation per byte, so bytes. The
// function must read x once and write y once.
//
// What this design does about it: every access to x and y is a 16-byte
// vector along the contiguous channel axis, so a warp's loads coalesce.
// The stats pass runs over (B, spatial tiles) blocks sized to fill the card;
// the finalize pass is tiny (B x G blocks over the per-tile stats); the apply
// pass is one FMA plus SiLU per element. x is read twice (stats, apply): the
// second read is the cost of a two-pass GroupNorm over tensors larger than
// one block's shared memory.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// Block-wide sum; every thread gets the total. `scratch` holds 32 floats.
__device__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();  // scratch may still be read from a previous call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  const int nwarps = (blockDim.x + 31) >> 5;
  float total = 0.f;
  for (int w = 0; w < nwarps; ++w) total += scratch[w];
  return total;
}

// stats [B, T, 2, C]: per tile and channel, the mean and M2 over the tile's rows.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ stats,
                int hw, int c, int tile_rows) {
  constexpr int VEC = DlVec<T>::kN;
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const int t = blockIdx.x;
  const int r0 = t * tile_rows;
  const int r1 = min(hw, r0 + tile_rows);
  const int rows = r1 - r0;
  const int nvec = c / VEC;
  // row groups: with few channel vectors, several threads share a channel
  // vector and split the tile's rows between them
  const int rg = max(1, static_cast<int>(blockDim.x) / nvec);
  float* s_mean = smem;
  float* s_m2 = smem + rg * c;
  const T* xb = x + static_cast<int64_t>(b) * hw * c;

  for (int slot = threadIdx.x; slot < rg * nvec; slot += blockDim.x) {
    const int g = slot / nvec;
    const int cv = slot - g * nvec;
    float mean[VEC], m2[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      mean[e] = 0.f;
      m2[e] = 0.f;
    }
    int count = 0;
    for (int r = r0 + g; r < r1; r += rg) {
      float xv[VEC];
      dl_load_vec(xb + static_cast<int64_t>(r) * c + cv * VEC, xv);
      ++count;
      const float inv = 1.f / static_cast<float>(count);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float delta = xv[e] - mean[e];
        mean[e] = fmaf(delta, inv, mean[e]);
        m2[e] = fmaf(delta, xv[e] - mean[e], m2[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      s_mean[g * c + cv * VEC + e] = mean[e];
      s_m2[g * c + cv * VEC + e] = m2[e];
    }
  }
  __syncthreads();

  float* out = stats + (static_cast<int64_t>(b) * gridDim.x + t) * 2 * c;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float n_a = 0.f, mean_a = 0.f, m2_a = 0.f;
    for (int g = 0; g < rg && g < rows; ++g) {
      // rows r0+g, r0+g+rg, ... below r1
      const float n_b = static_cast<float>((rows - g + rg - 1) / rg);
      const float n = n_a + n_b;
      const float delta = s_mean[g * c + ch] - mean_a;
      mean_a = fmaf(delta, n_b / n, mean_a);
      m2_a += s_m2[g * c + ch] + delta * delta * (n_a * n_b / n);
      n_a = n;
    }
    out[ch] = mean_a;
    out[c + ch] = m2_a;
  }
}

// One block per (group, batch): Chan-combine the group's tiles x channels,
// then fold gamma/beta into per-channel a, b.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_finalize_kernel(const float* __restrict__ stats, const T* __restrict__ gamma,
                   const T* __restrict__ beta, float* __restrict__ a,
                   float* __restrict__ bb, int hw, int c, int groups,
                   int ntiles, int tile_rows, float eps) {
  __shared__ float scratch[32];
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int cg = c / groups;
  const float* sb = stats + static_cast<int64_t>(b) * ntiles * 2 * c;
  const float total = static_cast<float>(hw) * static_cast<float>(cg);

  float s = 0.f;
  for (int i = threadIdx.x; i < ntiles * cg; i += blockDim.x) {
    const int t = i / cg;
    const int ch = g * cg + (i - t * cg);
    const float n_t = static_cast<float>(min(tile_rows, hw - t * tile_rows));
    s += n_t * sb[static_cast<int64_t>(t) * 2 * c + ch];
  }
  const float mu = block_sum(s, scratch) / total;

  float q = 0.f;
  for (int i = threadIdx.x; i < ntiles * cg; i += blockDim.x) {
    const int t = i / cg;
    const int ch = g * cg + (i - t * cg);
    const float n_t = static_cast<float>(min(tile_rows, hw - t * tile_rows));
    const float delta = sb[static_cast<int64_t>(t) * 2 * c + ch] - mu;
    q += sb[static_cast<int64_t>(t) * 2 * c + c + ch] + n_t * delta * delta;
  }
  const float var = block_sum(q, scratch) / total;
  const float inv = rsqrtf(var + eps);

  for (int i = threadIdx.x; i < cg; i += blockDim.x) {
    const int ch = g * cg + i;
    const float av = dl_to_float(gamma[ch]) * inv;
    a[static_cast<int64_t>(b) * c + ch] = av;
    bb[static_cast<int64_t>(b) * c + ch] = dl_to_float(beta[ch]) - mu * av;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ bb, T* __restrict__ y,
                int64_t hw, int c, int silu) {
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
      float t = fmaf(xv[e], av[e], bv[e]);
      if (silu) t = t / (1.f + expf(-t));
      yv[e] = t;
    }
    dl_store_vec(yb + i * VEC, yv);
  }
}

}  // namespace

// Each entry point returns cudaGetLastError() after its launch, or -1 for an
// unsupported dtype (the Python wrapper checks shapes and dtypes first).

extern "C" int dl_gn_stats(int device, const void* x, void* stats, int dtype,
                           int b, int hw, int c, int tile_rows, int ntiles,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(ntiles, b);
  const int vec = dtype == kFloat32 ? 4 : 8;
  const int nvec = c / vec;
  const int rg = nvec >= kThreads ? 1 : kThreads / nvec;
  const size_t smem = 2 * static_cast<size_t>(rg) * c * sizeof(float);
  if (dtype == kFloat32) {
    gn_stats_kernel<float><<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(x), static_cast<float*>(stats), hw, c, tile_rows);
  } else if (dtype == kBFloat16) {
    gn_stats_kernel<__nv_bfloat16><<<grid, kThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<float*>(stats), hw, c,
        tile_rows);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dl_gn_finalize(int device, const void* stats, const void* gamma,
                              const void* beta, void* a, void* bb, int dtype,
                              int b, int hw, int c, int groups, int ntiles,
                              int tile_rows, float eps, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(groups, b);
  if (dtype == kFloat32) {
    gn_finalize_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(stats), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<float*>(a),
        static_cast<float*>(bb), hw, c, groups, ntiles, tile_rows, eps);
  } else if (dtype == kBFloat16) {
    gn_finalize_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(stats), static_cast<const __nv_bfloat16*>(gamma),
        static_cast<const __nv_bfloat16*>(beta), static_cast<float*>(a),
        static_cast<float*>(bb), hw, c, groups, ntiles, tile_rows, eps);
  } else {
    return -1;
  }
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
    gn_apply_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(a),
        static_cast<const float*>(bb), static_cast<float*>(y), hw, c, silu);
  } else if (dtype == kBFloat16) {
    gn_apply_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(a),
        static_cast<const float*>(bb), static_cast<__nv_bfloat16*>(y), hw, c,
        silu);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

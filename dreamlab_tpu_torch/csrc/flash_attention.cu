// Flash attention for Hopper (sm_90a), fp32: non-causal softmax(Q K^T * scale) V.
//
// Replaces the Pallas TPU kernel dreamlab_tpu/ops/flash_attention.py::_flash_kernel
// (launched by flash_attention() through pl.pallas_call) for fp32 inputs;
// bf16 inputs take csrc/flash_wgmma.cu.
//
// What it computes: q [B, N, H, D], k/v [B, M, H, D] (any strides, last dim
// contiguous) -> o [B, N, H, D] contiguous fp32. Running max, denominator and
// accumulator are fp32, as in the Pallas kernel; the key edge is masked with
// the finite -1e30, so any M >= 1 works (77 included) without padding the
// inputs.
//
// The design (flash_fwd_kernel): one query row per thread, fp32 FMAs, K and V
// tiles staged in shared memory. The tensor cores would take fp32 as TF32,
// three decimal digits, which the fp32 checks against the plain version do
// not allow. Nothing is split over keys across blocks and there are no
// atomics: a row's result does not depend on the batch or on the run.

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// fp32: scalar kernel, one query row per thread
// ---------------------------------------------------------------------------

constexpr int kScalarBlockQ = 128;  // query rows (= threads) per block

template <int DP, int BK>
__global__ void __launch_bounds__(kScalarBlockQ)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 int n, int m, int h, int d,
                 int64_t q_sb, int64_t q_sn, int64_t q_sh,
                 int64_t k_sb, int64_t k_sm, int64_t k_sh,
                 int64_t v_sb, int64_t v_sm, int64_t v_sh,
                 float scale_log2) {
  constexpr int BQ = kScalarBlockQ;
  __shared__ __align__(16) float ks[BK][DP];
  __shared__ __align__(16) float vs[BK][DP];

  const int b = blockIdx.z;
  const int hh = blockIdx.y;
  const int row = blockIdx.x * BQ + threadIdx.x;
  const bool active = row < n;

  // q pre-scaled into the log2 domain: p = exp2(s - m) == exp(scale*qk - m')
  float qr[DP];
  float acc[DP];
#pragma unroll
  for (int c = 0; c < DP; ++c) {
    qr[c] = 0.f;
    acc[c] = 0.f;
  }
  if (active) {
    const float* qp = q + b * q_sb + static_cast<int64_t>(row) * q_sn + hh * q_sh;
#pragma unroll
    for (int c = 0; c < DP; ++c) {
      if (c < d) qr[c] = qp[c] * scale_log2;
    }
  }
  float row_max = kNegInf;
  float row_sum = 0.f;

  const float* kb = k + b * k_sb + hh * k_sh;
  const float* vb = v + b * v_sb + hh * v_sh;
  for (int j0 = 0; j0 < m; j0 += BK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = threadIdx.x; idx < BK * DP; idx += BQ) {
      const int j = idx / DP;
      const int c = idx - j * DP;
      const int key = j0 + j;
      float kval = 0.f, vval = 0.f;
      if (key < m && c < d) {
        kval = kb[static_cast<int64_t>(key) * k_sm + c];
        vval = vb[static_cast<int64_t>(key) * v_sm + c];
      }
      ks[j][c] = kval;
      vs[j][c] = vval;
    }
    __syncthreads();

    float s[BK];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(ks[j]);
      float dot = 0.f;
#pragma unroll
      for (int c4 = 0; c4 < DP / 4; ++c4) {
        const float4 kk = kr[c4];
        dot = fmaf(qr[4 * c4], kk.x, dot);
        dot = fmaf(qr[4 * c4 + 1], kk.y, dot);
        dot = fmaf(qr[4 * c4 + 2], kk.z, dot);
        dot = fmaf(qr[4 * c4 + 3], kk.w, dot);
      }
      s[j] = (j0 + j < m) ? dot : kNegInf;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float new_max = fmaxf(row_max, tile_max);
    const float alpha = exp2f(row_max - new_max);
#pragma unroll
    for (int c = 0; c < DP; ++c) acc[c] *= alpha;
    float tile_sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = exp2f(s[j] - new_max);
      tile_sum += p;
      const float4* vr = reinterpret_cast<const float4*>(vs[j]);
#pragma unroll
      for (int c4 = 0; c4 < DP / 4; ++c4) {
        const float4 vv = vr[c4];
        acc[4 * c4] = fmaf(p, vv.x, acc[4 * c4]);
        acc[4 * c4 + 1] = fmaf(p, vv.y, acc[4 * c4 + 1]);
        acc[4 * c4 + 2] = fmaf(p, vv.z, acc[4 * c4 + 2]);
        acc[4 * c4 + 3] = fmaf(p, vv.w, acc[4 * c4 + 3]);
      }
    }
    row_sum = row_sum * alpha + tile_sum;
    row_max = new_max;
  }

  if (active) {
    float* op = o + ((static_cast<int64_t>(b) * n + row) * h + hh) * d;
    const float inv = 1.f / row_sum;
#pragma unroll
    for (int c = 0; c < DP; ++c) {
      if (c < d) op[c] = acc[c] * inv;
    }
  }
}

// fewer keys per tile at wide heads keeps q, acc and the scores in registers
template <int DP>
void launch_scalar(const void* q, const void* k, const void* v, void* o,
                   int b, int n, int m, int h, int d,
                   const int64_t* qs, const int64_t* ks, const int64_t* vs,
                   float scale, cudaStream_t stream) {
  constexpr int BK = DP > 80 ? 16 : 32;
  const dim3 grid((n + kScalarBlockQ - 1) / kScalarBlockQ, h, b);
  flash_fwd_kernel<DP, BK><<<grid, kScalarBlockQ, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), n, m, h, d,
      qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
      scale * kLog2e);
}

int dispatch_fp32(const void* q, const void* k, const void* v, void* o,
                  int b, int n, int m, int h, int d,
                  const int64_t* qs, const int64_t* ks, const int64_t* vs,
                  float scale, cudaStream_t stream) {
#define DL_FLASH_CASE(DP)                                                      \
  if (d <= DP) {                                                               \
    launch_scalar<DP>(q, k, v, o, b, n, m, h, d, qs, ks, vs, scale, stream);   \
    return 0;                                                                  \
  }
  // the widths of the UNet heads (SD1.5: 40, 80; SDXL: 64), the tiny test
  // configs (16) and the widest head the dispatcher sends (128); other head
  // dims run zero-padded to the next of these
  DL_FLASH_CASE(16)
  DL_FLASH_CASE(40)
  DL_FLASH_CASE(64)
  DL_FLASH_CASE(80)
  DL_FLASH_CASE(128)
#undef DL_FLASH_CASE
  return -1;
}

}  // namespace

// Returns cudaGetLastError() after the launch, or -1 for an unsupported
// dtype / head dim (the Python wrapper checks both before calling).
extern "C" int dl_flash_attention(
    int device, const void* q, const void* k, const void* v, void* o,
    int dtype, int b, int n, int m, int h, int d,
    int64_t q_sb, int64_t q_sn, int64_t q_sh,
    int64_t k_sb, int64_t k_sm, int64_t k_sh,
    int64_t v_sb, int64_t v_sm, int64_t v_sh,
    float scale, void* stream) {
  if (dtype != kFloat32) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t qs[3] = {q_sb, q_sn, q_sh};
  const int64_t ks[3] = {k_sb, k_sm, k_sh};
  const int64_t vs[3] = {v_sb, v_sm, v_sh};
  const int rc = dispatch_fp32(q, k, v, o, b, n, m, h, d, qs, ks, vs, scale,
                               static_cast<cudaStream_t>(stream));
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// Head-group flash attention for Hopper (sm_90a): non-causal
// softmax(Q K^T * scale) V where one block owns PACK lane-adjacent heads.
//
// Replaces two Pallas TPU kernels of the layout probes:
//   scripts/ab_transpose_free.py::flash_attention_4d (K1's _flash_kernel run
//     through a 4-D BlockSpec over [B, N, G, L], pack heads per grid step);
//   scripts/ab_head_packing.py::_packed3_kernel (3 heads per 128-lane block,
//     launched by flash_attention_packed3).
//
// What it computes: q [B, N, H, D], k/v [B, M, H, D] with the heads
// lane-adjacent (head stride D, last dim contiguous; batch and token strides
// free) -> o [B, N, H, D] contiguous, in q's dtype (fp32 or bf16). Group g is
// heads [g*PACK, (g+1)*PACK): L = PACK*D contiguous elements of each token
// row, so the kernel reads the [B, N, G, L] view in place, a pure reshape of
// [B, N, H, D]: no transpose and no lane pad (the TPU probe's fold). Running
// max, denominator and accumulator are fp32; the ragged key edge is masked
// with the finite -1e30, as csrc/flash_attention.cu does, so any M >= 1 works.
//
// What bounds it on this card: the same work as the one-head kernel,
// 4*B*H*N*M*D operations on B*H*(N+2M)*D inputs, far above the H100's ~295
// operations per byte, so the bound is arithmetic; this scalar version runs
// it on the fp32 units, not the tensor cores (a later change).
//
// What the design does about it: one block of 128*PACK threads owns
// (b, g, 128 queries); thread t serves head t / 128 of the group (uniform
// across a warp, so shared-memory reads broadcast) and query row t % 128,
// with q and the accumulator of one head in registers, as in the one-head
// kernel. Holding all PACK heads in one thread would need PACK x 40 lanes of
// q and acc in registers and spill. Each K/V tile is loaded ONCE, as L-wide
// contiguous token rows, into shared memory and feeds all PACK heads: the one
// thing a head group can buy on this card (wider coalesced rows, one tile
// fill and barrier pair for PACK heads, PACK times fewer blocks).

#include "common.cuh"

namespace {

constexpr int kRows = 128;  // query rows per block; one thread per (row, head)
constexpr int kBlockK = 32;  // keys per shared-memory tile
constexpr float kNegInf = -1e30f;  // finite mask value, as in the Pallas kernel
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int PACK, int DP>
__global__ void __launch_bounds__(kRows * PACK)
flash_group_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ o,
                   int n, int m, int h, int d,
                   int64_t q_sb, int64_t q_sn, int64_t k_sb, int64_t k_sm,
                   int64_t v_sb, int64_t v_sm, float scale_log2) {
  // one tile: kBlockK token rows of the group's PACK heads, each head padded
  // to DP lanes (zeros) so that a head's row is 16-byte aligned for float4
  __shared__ __align__(16) float ks[kBlockK][PACK][DP];
  __shared__ __align__(16) float vs[kBlockK][PACK][DP];

  const int b = blockIdx.z;
  const int g = blockIdx.y;
  const int hd = threadIdx.x / kRows;  // head within the group
  const int row = blockIdx.x * kRows + threadIdx.x % kRows;
  const bool active = row < n;
  const int64_t lane0 = static_cast<int64_t>(g) * PACK * d;  // group's first lane

  // q pre-scaled into the log2 domain: p = exp2(s - m) == exp(scale*qk - m')
  float qr[DP];
  float acc[DP];
#pragma unroll
  for (int c = 0; c < DP; ++c) {
    qr[c] = 0.f;
    acc[c] = 0.f;
  }
  if (active) {
    const T* qp = q + b * q_sb + static_cast<int64_t>(row) * q_sn + lane0 + hd * d;
#pragma unroll
    for (int c = 0; c < DP; ++c) {
      if (c < d) qr[c] = dl_to_float(qp[c]) * scale_log2;
    }
  }
  float row_max = kNegInf;
  float row_sum = 0.f;

  const T* kb = k + b * k_sb + lane0;
  const T* vb = v + b * v_sb + lane0;
  for (int j0 = 0; j0 < m; j0 += kBlockK) {
    __syncthreads();  // every thread is done with the previous tile
    // neighbouring threads read neighbouring lanes of one L-wide token row
    for (int idx = threadIdx.x; idx < kBlockK * PACK * DP; idx += kRows * PACK) {
      const int j = idx / (PACK * DP);
      const int rem = idx - j * PACK * DP;
      const int jh = rem / DP;
      const int c = rem - jh * DP;
      const int key = j0 + j;
      float kval = 0.f, vval = 0.f;
      if (key < m && c < d) {
        kval = dl_to_float(kb[static_cast<int64_t>(key) * k_sm + jh * d + c]);
        vval = dl_to_float(vb[static_cast<int64_t>(key) * v_sm + jh * d + c]);
      }
      ks[j][jh][c] = kval;
      vs[j][jh][c] = vval;
    }
    __syncthreads();

    float s[kBlockK];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(ks[j][hd]);
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
    for (int j = 0; j < kBlockK; ++j) {
      const float p = exp2f(s[j] - new_max);
      tile_sum += p;
      const float4* vr = reinterpret_cast<const float4*>(vs[j][hd]);
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
    T* op = o + ((static_cast<int64_t>(b) * n + row) * h + g * PACK + hd) * d;
    const float inv = 1.f / row_sum;
#pragma unroll
    for (int c = 0; c < DP; ++c) {
      if (c < d) dl_store(op + c, acc[c] * inv);
    }
  }
}

template <typename T, int PACK, int DP>
void launch(const void* q, const void* k, const void* v, void* o,
            int b, int n, int m, int h, int d, const int64_t* st,
            float scale, cudaStream_t stream) {
  const dim3 grid((n + kRows - 1) / kRows, h / PACK, b);
  flash_group_kernel<T, PACK, DP><<<grid, kRows * PACK, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), n, m, h, d,
      st[0], st[1], st[2], st[3], st[4], st[5], scale * kLog2e);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int pack,
             int b, int n, int m, int h, int d, const int64_t* st,
             float scale, cudaStream_t stream) {
#define DL_GROUP_CASE(P, DP)                                               \
  if (pack == P && d <= DP) {                                              \
    launch<T, P, DP>(q, k, v, o, b, n, m, h, d, st, scale, stream);        \
    return 0;                                                              \
  }
  // the probes' groups: pack 3 at d = 40 (L = 120) and pack 2 at d = 40 / 64
  // (L = 80 / 128), plus d = 16 for the small tests; other head dims run
  // zero-padded in registers to the next of these
  DL_GROUP_CASE(2, 16)
  DL_GROUP_CASE(2, 40)
  DL_GROUP_CASE(2, 64)
  DL_GROUP_CASE(3, 16)
  DL_GROUP_CASE(3, 40)
#undef DL_GROUP_CASE
  return -1;
}

}  // namespace

// Returns cudaGetLastError() after the launch, or -1 for an unsupported
// dtype / pack / head dim (the Python wrapper checks all three before calling).
extern "C" int dl_flash_group(
    int device, const void* q, const void* k, const void* v, void* o,
    int dtype, int pack, int b, int n, int m, int h, int d,
    int64_t q_sb, int64_t q_sn, int64_t k_sb, int64_t k_sm,
    int64_t v_sb, int64_t v_sm, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t st[6] = {q_sb, q_sn, k_sb, k_sm, v_sb, v_sm};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = -1;
  if (dtype == kFloat32) {
    rc = dispatch<float>(q, k, v, o, pack, b, n, m, h, d, st, scale, s);
  } else if (dtype == kBFloat16) {
    rc = dispatch<__nv_bfloat16>(q, k, v, o, pack, b, n, m, h, d, st, scale, s);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

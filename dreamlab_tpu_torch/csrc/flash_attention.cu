// Flash attention for Hopper (sm_90a): non-causal softmax(Q K^T * scale) V.
//
// Replaces the Pallas TPU kernel dreamlab_tpu/ops/flash_attention.py::_flash_kernel
// (launched by flash_attention() through pl.pallas_call).
//
// What it computes: q [B, N, H, D], k/v [B, M, H, D] (any strides, last dim
// contiguous) -> o [B, N, H, D] contiguous, in q's dtype (fp32 or bf16).
// Running max, denominator and accumulator are fp32, as in the Pallas kernel;
// the key edge is masked with the finite -1e30, so any M >= 1 works (77
// included) without padding the inputs.
//
// What bounds it on this card: 4*B*H*N*M*D operations on B*H*(2N+2M)*D
// elements. At the UNet's shapes (N = M = 4096 at D = 40, N = M = 1024 at
// D = 80) that is about 1,000 operations per byte, far above the H100's ~295,
// so the bound is arithmetic: 0.489 ms per 512x512 request at the 989 TFLOP/s
// bf16 tensor-core peak.
//
// What this design does about it (bf16, flash_mma_kernel; its building blocks
// are in csrc/mma.cuh, shared with the head-group kernel of csrc/flash_group.cu):
// both products run on the tensor cores, mma.sync m16n8k16 with bf16 operands and fp32
// accumulators. One block owns (b, h, BQ queries) and BQ/16 warps; each warp
// owns 16 query rows, loads their Q fragment once (ldmatrix) and keeps it in
// registers. The block walks the keys in tiles of BK, staged in shared memory
// and double-buffered with 16-byte cp.async copies, so the next tile's load
// overlaps this tile's products. The head dim is zero-filled in shared memory
// to the next multiple of 16 (40 -> 48; 16, 64, 80 and 128 unchanged): never
// to 128. Where a row start is not 16-byte aligned (or d % 8 != 0) the tiles
// are staged element by element instead. The online softmax stays in
// registers: exp2 with the scale folded into log2(e), row max and row sum
// over the 4 threads of a quad, the row sum over fp32 p (the Pallas kernel's
// l_scr update). P is rounded to bf16 (the Pallas kernel's p.astype(v.dtype))
// and fed straight back as the A operand of O += P V: an m16n8 accumulator
// pair has the layout of an m16n8k16 A fragment, so P never touches shared
// memory. V is read with ldmatrix.trans. Nothing is split over keys across
// blocks and there are no atomics: a row's result does not depend on the
// batch or on the run. Rows of shared memory are padded by 16 bytes so that
// ldmatrix reads no bank twice.
//
// fp32 inputs keep the scalar kernel (flash_fwd_kernel: one query row per
// thread, fp32 FMAs): the tensor cores would take fp32 as TF32, three decimal
// digits, which the fp32 checks against the plain version do not allow.
//
// Left for later: wgmma (the only way to the full tensor-core rate; mma.sync
// reaches well below it), TMA loads with mbarriers, and a producer warp that
// keeps them in flight while the consumer warps compute.

#include <initializer_list>

#include "mma.cuh"

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

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

// the main path's tiles (dreamlab_tpu_torch/ops/flash_attention.py mirrors them)
constexpr int kBlockQ = 128;
constexpr int kBlockK = 64;

template <int DP, int BQ, int BK>
__global__ void __launch_bounds__(BQ * 2)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 int n, int m, int h, int d,
                 int64_t q_sb, int64_t q_sn, int64_t q_sh,
                 int64_t k_sb, int64_t k_sm, int64_t k_sh,
                 int64_t v_sb, int64_t v_sm, int64_t v_sh,
                 float scale_log2, int vec) {
  static_assert(DP % 16 == 0 && BQ % 16 == 0 && BK % 16 == 0, "mma tiles are 16 deep");
  constexpr int NT = BQ * 2;   // threads: BQ / 16 warps
  constexpr int LD = DP + 8;   // shared row pitch: +16 bytes, no ldmatrix bank conflicts
  constexpr int KD = DP / 16;  // k-steps of S = Q K^T
  constexpr int NS = BK / 8;   // n-tiles of S (keys)
  constexpr int KP = BK / 16;  // k-steps of O += P V
  constexpr int NO = DP / 8;   // n-tiles of O (head dims)

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* sk = sq + BQ * LD;                       // [2][BK][LD]
  bf16* sv = sk + 2 * BK * LD;                   // [2][BK][LD]

  const int b = blockIdx.z;
  const int hh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // accumulator row (and row + 8) of this thread
  const int t = lane & 3;   // accumulator columns 2t, 2t + 1
  const bf16* qb = q + b * q_sb + hh * q_sh;
  const bf16* kb = k + b * k_sb + hh * k_sh;
  const bf16* vb = v + b * v_sb + hh * v_sh;

  stage_tile<BQ, 1, DP, LD, NT>(sq, qb, q_sn, q0, n, d, vec);
  stage_tile<BK, 1, DP, LD, NT>(sk, kb, k_sm, 0, m, d, vec);
  stage_tile<BK, 1, DP, LD, NT>(sv, vb, v_sm, 0, m, d, vec);
  cp_async_commit();

  uint32_t qf[KD][4];
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // rows g and g + 8: running max (log2 domain) and this thread's share of the sum
  float row_max[2] = {kNegInf, kNegInf};
  float row_sum[2] = {0.f, 0.f};

  const int ntiles = (m + BK - 1) / BK;
  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1;
    if (it + 1 < ntiles) {
      // the other buffer was released by the barrier that ended the last tile
      stage_tile<BK, 1, DP, LD, NT>(sk + (st ^ 1) * BK * LD, kb, k_sm, (it + 1) * BK, m, d, vec);
      stage_tile<BK, 1, DP, LD, NT>(sv + (st ^ 1) * BK * LD, vb, v_sm, (it + 1) * BK, m, d, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        ldmatrix_x4(qf[kk], sq + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                kk * 16 + (lane >> 4) * 8);
      }
    }
    const bf16* skt = sk + st * BK * LD;
    const bf16* svt = sv + st * BK * LD;

    // S = Q K^T for this warp's 16 rows and the tile's BK keys
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        uint32_t kf[4];
        ldmatrix_x4(kf, skt + (jp * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * jp], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // online softmax in the log2 domain; e >> 1 selects row g or g + 8
    const int key0 = it * BK;
    float tile_max[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + j * 8 + 2 * t + (e & 1);
        const float x = key < m ? s[j][e] * scale_log2 : kNegInf;
        s[j][e] = x;
        tile_max[e >> 1] = fmaxf(tile_max[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
      const float new_max = fmaxf(row_max[r], tile_max[r]);
      alpha[r] = exp2f(row_max[r] - new_max);
      row_max[r] = new_max;
      row_sum[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - row_max[e >> 1]);
        s[j][e] = p;
        row_sum[e >> 1] += p;  // fp32 p, as the Pallas kernel sums it
      }
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V: P rounded to bf16 in registers, V^T fragments by ldmatrix.trans
#pragma unroll
    for (int kp = 0; kp < KP; ++kp) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kp][0], s[2 * kp][1]);
      pa[1] = pack_bf16(s[2 * kp][2], s[2 * kp][3]);
      pa[2] = pack_bf16(s[2 * kp + 1][0], s[2 * kp + 1][1]);
      pa[3] = pack_bf16(s[2 * kp + 1][2], s[2 * kp + 1][3]);
#pragma unroll
      for (int jp = 0; jp < NO / 2; ++jp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, svt + (kp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                  jp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * jp], pa, vf[0], vf[1]);
        mma_bf16(acc[2 * jp + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // the tile's buffers may be refilled
  }

  // the quad's shares of each row sum, then O / l stored as bf16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 1);
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    if (row >= n) continue;
    const float inv = 1.f / row_sum[r];
    bf16* op = o + ((static_cast<int64_t>(b) * n + row) * h + hh) * d;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int c = j * 8 + 2 * t;
      const float x0 = acc[j][2 * r] * inv;
      const float x1 = acc[j][2 * r + 1] * inv;
      if (c + 1 < d && (d & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(op + c) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (c < d) op[c] = __float2bfloat16(x0);
        if (c + 1 < d) op[c + 1] = __float2bfloat16(x1);
      }
    }
  }
}

template <int DP, int BQ, int BK>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               int b, int n, int m, int h, int d,
               const int64_t* qs, const int64_t* ks, const int64_t* vs,
               float scale, int vec, cudaStream_t stream) {
  constexpr size_t smem = flash_smem_bytes<1, DP, BQ, BK>();
  static const cudaError_t err = allow_smem(flash_mma_kernel<DP, BQ, BK>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BQ - 1) / BQ, h, b);
  flash_mma_kernel<DP, BQ, BK><<<grid, BQ * 2, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), n, m, h, d,
      qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
      scale * kLog2e, vec);
  return 0;
}

int dispatch_bf16(const void* q, const void* k, const void* v, void* o,
                  int b, int n, int m, int h, int d, int block_q, int block_k,
                  const int64_t* qs, const int64_t* ks, const int64_t* vs,
                  float scale, cudaStream_t stream) {
  // 16-byte copies need every row start 16-byte aligned: base pointers and
  // the batch, token and head strides, in elements of 2 bytes
  bool vec = d % 8 == 0;
  for (const void* p : {q, k, v}) vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  for (const int64_t* s : {qs, ks, vs}) vec = vec && s[0] % 8 == 0 && s[1] % 8 == 0 && s[2] % 8 == 0;
  const int vi = vec ? 1 : 0;
  if (block_q != 0 || block_k != 0) {
    // the probes' tile sweep, compiled at the d = 40 head (depth 48)
    if (d > 48) return -1;
#define DL_SWEEP_CASE(BQ, BK)                                                         \
  if (block_q == BQ && block_k == BK) {                                               \
    return launch_mma<48, BQ, BK>(q, k, v, o, b, n, m, h, d, qs, ks, vs, scale, vi,   \
                                  stream);                                            \
  }
    DL_SWEEP_CASE(64, 16)
    DL_SWEEP_CASE(64, 32)
    DL_SWEEP_CASE(64, 64)
    DL_SWEEP_CASE(128, 16)
    DL_SWEEP_CASE(128, 32)
    DL_SWEEP_CASE(128, 64)
#undef DL_SWEEP_CASE
    return -1;
  }
#define DL_MMA_CASE(DP)                                                              \
  if (d <= DP) {                                                                     \
    return launch_mma<DP, kBlockQ, kBlockK>(q, k, v, o, b, n, m, h, d, qs, ks, vs,   \
                                            scale, vi, stream);                      \
  }
  // the mma depth is 16: d = 40 runs at 48; 16, 64, 80 (the UNet's heads and
  // the tiny configs') and 128 (the widest the dispatcher sends) unpadded
  DL_MMA_CASE(16)
  DL_MMA_CASE(48)
  DL_MMA_CASE(64)
  DL_MMA_CASE(80)
  DL_MMA_CASE(128)
#undef DL_MMA_CASE
  return -1;
}

}  // namespace

// Returns cudaGetLastError() after the launch, or -1 for an unsupported
// dtype / head dim / tile (the Python wrapper checks all three before
// calling). block_q = block_k = 0 selects the default tiles; other tiles are
// compiled for bf16 at d <= 48 only.
extern "C" int dl_flash_attention(
    int device, const void* q, const void* k, const void* v, void* o,
    int dtype, int b, int n, int m, int h, int d, int block_q, int block_k,
    int64_t q_sb, int64_t q_sn, int64_t q_sh,
    int64_t k_sb, int64_t k_sm, int64_t k_sh,
    int64_t v_sb, int64_t v_sm, int64_t v_sh,
    float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t qs[3] = {q_sb, q_sn, q_sh};
  const int64_t ks[3] = {k_sb, k_sm, k_sh};
  const int64_t vs[3] = {v_sb, v_sm, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = -1;
  if (dtype == kBFloat16) {
    rc = dispatch_bf16(q, k, v, o, b, n, m, h, d, block_q, block_k, qs, ks, vs, scale, st);
  } else if (dtype == kFloat32 && block_q == 0 && block_k == 0) {
    rc = dispatch_fp32(q, k, v, o, b, n, m, h, d, qs, ks, vs, scale, st);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

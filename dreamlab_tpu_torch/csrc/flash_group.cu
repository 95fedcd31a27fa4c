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
// 4*B*H*N*M*D operations on B*H*(2N+2M)*D elements, far above the H100's ~295
// operations per byte, so the bound is arithmetic (the bf16 tensor-core peak).
//
// What the design does about it (bf16, flash_group_mma_kernel): the one-head
// kernel's tensor-core loop (csrc/flash_attention.cu::flash_mma_kernel, with
// its building blocks from csrc/mma.cuh: mma.sync m16n8k16, Q fragments in
// registers, online softmax in the log2 domain over the quad, P rounded to
// bf16 and fed back from registers, V by ldmatrix.trans, 16-byte cp.async
// into a double buffer), with 4 warps (64 query rows) per head and 4 * PACK
// warps in a block. Each K/V tile of 64 keys is staged ONCE, as L-wide
// contiguous token rows, and feeds all PACK heads: one tile fill and one
// barrier pair for PACK heads, and PACK times fewer blocks, are what a head
// group can buy on this card. In shared memory each head's slice is
// zero-filled to the mma depth (40 -> 48; 16 and 64 unchanged) and a row is
// PACK * depth + 8 elements (152 at pack 3, d = 40; 136 at pack 2, d = 64),
// an odd multiple of 16 bytes, so ldmatrix reads no bank twice. Where
// d % 8 != 0 or a row start is not 16-byte aligned the tiles are staged
// element by element. 64 rows per head, not the one-head kernel's 128, keep
// a block within the SM's registers: 768 threads at ~125 registers would not
// fit. At pack 3, d = 40 the block takes 97 KB of dynamic shared memory.
// Nothing is split over keys across blocks and there are no atomics, so two
// calls on the same inputs give the same bytes.
//
// fp32 inputs keep the scalar kernel (flash_group_fwd_kernel: one thread per
// (query row, head), fp32 FMAs, each K/V tile loaded once for the group), as
// the one-head kernel does: TF32 would break the fp32 checks.

#include <initializer_list>

#include "mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// fp32: scalar kernel, one thread per (query row, head)
// ---------------------------------------------------------------------------

constexpr int kScalarRows = 128;   // query rows per block
constexpr int kScalarBlockK = 32;  // keys per shared-memory tile

template <int PACK, int DP>
__global__ void __launch_bounds__(kScalarRows * PACK)
flash_group_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int n, int m, int h, int d,
                       int64_t q_sb, int64_t q_sn, int64_t k_sb, int64_t k_sm,
                       int64_t v_sb, int64_t v_sm, float scale_log2) {
  // one tile: kScalarBlockK token rows of the group's PACK heads, each head
  // padded to DP lanes (zeros) so that a head's row is 16-byte aligned for float4
  __shared__ __align__(16) float ks[kScalarBlockK][PACK][DP];
  __shared__ __align__(16) float vs[kScalarBlockK][PACK][DP];

  const int b = blockIdx.z;
  const int g = blockIdx.y;
  const int hd = threadIdx.x / kScalarRows;  // head within the group (uniform per warp)
  const int row = blockIdx.x * kScalarRows + threadIdx.x % kScalarRows;
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
    const float* qp = q + b * q_sb + static_cast<int64_t>(row) * q_sn + lane0 + hd * d;
#pragma unroll
    for (int c = 0; c < DP; ++c) {
      if (c < d) qr[c] = qp[c] * scale_log2;
    }
  }
  float row_max = kNegInf;
  float row_sum = 0.f;

  const float* kb = k + b * k_sb + lane0;
  const float* vb = v + b * v_sb + lane0;
  for (int j0 = 0; j0 < m; j0 += kScalarBlockK) {
    __syncthreads();  // every thread is done with the previous tile
    // neighbouring threads read neighbouring lanes of one L-wide token row
    for (int idx = threadIdx.x; idx < kScalarBlockK * PACK * DP; idx += kScalarRows * PACK) {
      const int j = idx / (PACK * DP);
      const int rem = idx - j * PACK * DP;
      const int jh = rem / DP;
      const int c = rem - jh * DP;
      const int key = j0 + j;
      float kval = 0.f, vval = 0.f;
      if (key < m && c < d) {
        kval = kb[static_cast<int64_t>(key) * k_sm + jh * d + c];
        vval = vb[static_cast<int64_t>(key) * v_sm + jh * d + c];
      }
      ks[j][jh][c] = kval;
      vs[j][jh][c] = vval;
    }
    __syncthreads();

    float s[kScalarBlockK];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kScalarBlockK; ++j) {
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
    for (int j = 0; j < kScalarBlockK; ++j) {
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
    float* op = o + ((static_cast<int64_t>(b) * n + row) * h + g * PACK + hd) * d;
    const float inv = 1.f / row_sum;
#pragma unroll
    for (int c = 0; c < DP; ++c) {
      if (c < d) op[c] = acc[c] * inv;
    }
  }
}

template <int PACK, int DP>
void launch_scalar(const void* q, const void* k, const void* v, void* o,
                   int b, int n, int m, int h, int d, const int64_t* st,
                   float scale, cudaStream_t stream) {
  const dim3 grid((n + kScalarRows - 1) / kScalarRows, h / PACK, b);
  flash_group_fwd_kernel<PACK, DP><<<grid, kScalarRows * PACK, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), n, m, h, d,
      st[0], st[1], st[2], st[3], st[4], st[5], scale * kLog2e);
}

int dispatch_fp32(const void* q, const void* k, const void* v, void* o, int pack,
                  int b, int n, int m, int h, int d, const int64_t* st,
                  float scale, cudaStream_t stream) {
#define DL_GROUP_CASE(P, DP)                                                 \
  if (pack == P && d <= DP) {                                                \
    launch_scalar<P, DP>(q, k, v, o, b, n, m, h, d, st, scale, stream);      \
    return 0;                                                                \
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

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel (mma.sync m16n8k16), the one-head kernel's loop
// (csrc/flash_attention.cu::flash_mma_kernel) over PACK heads per block. The
// loop is a copy, not a function both kernels call: moving it into one
// changed the one-head kernel's register counts (PERF.md).
// ---------------------------------------------------------------------------

constexpr int kGroupRows = 64;    // query rows of each head per block (4 warps)
constexpr int kGroupBlockK = 64;  // keys per tile

// Blocks per SM the register file holds at 128 registers a thread: two at
// pack 2 (256 threads), one at pack 3 (384). Asked of ptxas as a minimum, so
// that a few registers more never halve the warps an SM runs (at pack 2,
// d = 64 ptxas took 130 unasked: one block per SM, 0.643 ms against 0.52
// with two on the probe's (2, 4096, 10, 64); PERF.md).
constexpr int group_min_blocks(int pack) { return 65536 / (kGroupRows * 2 * pack * 128); }

// One block per (b, group grp, 64 queries): 4 warps for each of the PACK
// heads, 16 query rows per warp. Warp w serves head w / 4 of the group; its
// head's dims start `col` elements into every shared row.
template <int PACK, int DP>
__global__ void __launch_bounds__(kGroupRows * 2 * PACK, group_min_blocks(PACK))
flash_group_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       int n, int m, int h, int d,
                       int64_t q_sb, int64_t q_sn, int64_t k_sb, int64_t k_sm,
                       int64_t v_sb, int64_t v_sm, float scale_log2, int vec) {
  constexpr int BQ = kGroupRows;
  constexpr int BK = kGroupBlockK;
  constexpr int WPH = BQ / 16;         // warps per head
  constexpr int NT = 32 * WPH * PACK;  // threads
  constexpr int LD = PACK * DP + 8;    // shared row pitch: an odd multiple of 16 bytes
  constexpr int KD = DP / 16;          // k-steps of S = Q K^T
  constexpr int NS = BK / 8;           // n-tiles of S (keys)
  constexpr int KP = BK / 16;          // k-steps of O += P V
  constexpr int NO = DP / 8;           // n-tiles of O (head dims)
  static_assert(DP % 16 == 0, "mma tiles are 16 deep");
  // The Q fragments stay in registers across the key loop, as in the one-head
  // kernel, except at pack 2, d = 64: there they would not fit the 128
  // registers of two blocks per SM (8 bytes of spills), so each tile reloads
  // them from shared memory (KD more ldmatrix a tile; PERF.md has the A/B).
  constexpr bool kHoldQ = !(PACK == 2 && DP == 64);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* sk = sq + BQ * LD;                       // [2][BK][LD]
  bf16* sv = sk + 2 * BK * LD;                   // [2][BK][LD]

  const int b = blockIdx.z;
  const int grp = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // accumulator row (and row + 8) of this thread
  const int t = lane & 3;   // accumulator columns 2t, 2t + 1
  const int hd = warp / WPH;              // this warp's head in the group
  const int row0 = (warp - hd * WPH) * 16;  // its first query row in the block
  const int col = hd * DP;                // its head's first dim in a shared row
  const int64_t lane0 = static_cast<int64_t>(grp) * PACK * d;  // group's first lane
  const bf16* qb = q + b * q_sb + lane0;
  const bf16* kb = k + b * k_sb + lane0;
  const bf16* vb = v + b * v_sb + lane0;

  // one fill of each tile serves all PACK heads
  stage_tile<BQ, PACK, DP, LD, NT>(sq, qb, q_sn, q0, n, d, vec);
  stage_tile<BK, PACK, DP, LD, NT>(sk, kb, k_sm, 0, m, d, vec);
  stage_tile<BK, PACK, DP, LD, NT>(sv, vb, v_sm, 0, m, d, vec);
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
      stage_tile<BK, PACK, DP, LD, NT>(sk + (st ^ 1) * BK * LD, kb, k_sm, (it + 1) * BK, m, d,
                                       vec);
      stage_tile<BK, PACK, DP, LD, NT>(sv + (st ^ 1) * BK * LD, vb, v_sm, (it + 1) * BK, m, d,
                                       vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (it == 0 || !kHoldQ) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        ldmatrix_x4(qf[kk], sq + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + col +
                                kk * 16 + (lane >> 4) * 8);
      }
    }
    const bf16* skt = sk + st * BK * LD + col;
    const bf16* svt = sv + st * BK * LD + col;

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
        row_sum[e >> 1] += p;  // fp32 p, as the Pallas kernels sum it
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
    const int row = q0 + row0 + g + r * 8;
    if (row >= n) continue;
    const float inv = 1.f / row_sum[r];
    bf16* op = o + ((static_cast<int64_t>(b) * n + row) * h + grp * PACK + hd) * d;
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

template <int PACK, int DP>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               int b, int n, int m, int h, int d, const int64_t* st,
               float scale, int vec, cudaStream_t stream) {
  constexpr size_t smem = flash_smem_bytes<PACK, DP, kGroupRows, kGroupBlockK>();
  static const cudaError_t err = allow_smem(flash_group_mma_kernel<PACK, DP>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kGroupRows - 1) / kGroupRows, h / PACK, b);
  flash_group_mma_kernel<PACK, DP><<<grid, kGroupRows * 2 * PACK, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), n, m, h, d,
      st[0], st[1], st[2], st[3], st[4], st[5], scale * kLog2e, vec);
  return 0;
}

int dispatch_bf16(const void* q, const void* k, const void* v, void* o, int pack,
                  int b, int n, int m, int h, int d, const int64_t* st,
                  float scale, cudaStream_t stream) {
  // 16-byte copies need every head's row start 16-byte aligned: base
  // pointers, the batch and token strides and the head offsets (multiples
  // of d), in elements of 2 bytes
  bool vec = d % 8 == 0;
  for (const void* p : {q, k, v}) vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  for (int i = 0; i < 6; ++i) vec = vec && st[i] % 8 == 0;
  const int vi = vec ? 1 : 0;
#define DL_GROUP_CASE(P, DP)                                                        \
  if (pack == P && d <= DP) {                                                       \
    return launch_mma<P, DP>(q, k, v, o, b, n, m, h, d, st, scale, vi, stream);     \
  }
  // the mma depth is 16: d = 40 runs at 48 (pack 3: L = 120; pack 2: L = 80),
  // d = 64 at 64 (pack 2: L = 128), d <= 16 (the small tests) at 16; other
  // head dims run zero-filled to the next of these
  DL_GROUP_CASE(2, 16)
  DL_GROUP_CASE(2, 48)
  DL_GROUP_CASE(2, 64)
  DL_GROUP_CASE(3, 16)
  DL_GROUP_CASE(3, 48)
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
    rc = dispatch_fp32(q, k, v, o, pack, b, n, m, h, d, st, scale, s);
  } else if (dtype == kBFloat16) {
    rc = dispatch_bf16(q, k, v, o, pack, b, n, m, h, d, st, scale, s);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// Flash attention for Hopper (sm_90a), bf16: non-causal softmax(Q K^T * scale) V
// with wgmma, TMA and a warp-specialised pipeline.
//
// Replaces the Pallas TPU kernel dreamlab_tpu/ops/flash_attention.py::_flash_kernel
// (launched by flash_attention() through pl.pallas_call), as csrc/flash_attention.cu's
// flash_mma_kernel did before it; that kernel stays for the inputs TMA cannot
// describe (ops/flash_attention.py::route says which).
//
// What it computes: q [B, N, H, D], k/v [B, M, H, D] in bf16, read in place
// through their strides (the packed projection's views included: token
// stride 3*H*D) -> o [B, N, H, D] contiguous bf16. The arithmetic is
// flash_mma_kernel's: fp32 scores, exp2 with the scale folded into log2(e),
// keys >= M masked with the finite -1e30, the row sum over fp32 p, P rounded
// to bf16 before the PV product (the Pallas kernel's p.astype(v.dtype)),
// fp32 accumulation, O / l rounded to bf16 once.
//
// What bounds it on this card: 4*B*H*N*M*D tensor-core operations on
// B*H*(2N + 2M)*D elements, about 1,000 operations per byte at the UNet's
// shapes, far above the H100's ~295: the bound is arithmetic (0.489 ms per
// SD1.5 512x512 request, 3.04 ms per SDXL 1024x1024 request at 989 TFLOP/s).
// At d <= 64 the exponentials (one MUFU ex2 per score, 16 a clock per SM)
// take about as long as the two products; that is the next limit.
//
// The design, against what held flash_mma_kernel back:
// 1. Ampere instructions (mma.sync, cp.async, ldmatrix) -> Hopper's. Both
//    products are wgmma.mma_async: S = Q K^T m64n64k16 with Q and K read
//    from shared memory (K-major, as stored), O += P V m64nDk16 with P in
//    registers (the S accumulator's layout is wgmma's register-A layout, so
//    P never touches shared memory) and V through an MN-major descriptor.
//    Tiles arrive by TMA (cp.async.bulk.tensor) from tensor maps encoded on
//    the host over q, k and v's own strides; the head dim is zero-filled to
//    the next multiple of 16 by TMA's out-of-bounds fill (40 -> 48), never
//    by a copy, and so are the key and query edges. Rows of 128 bytes (the
//    128-byte swizzle, one box of 64 dims) where d is 64 or 128, else 32
//    (boxes of 16 dims): TMA's cost goes by the rows it fetches, and the
//    wider rows feed one-consumer blocks at d = 64 much faster.
// 2. Eight warps each reading all of K and V through ldmatrix, one block an
//    SM -> a consumer warpgroup owns 64 query rows, and one block's 1-3
//    consumers share each K/V tile TMA brought in once, read by the tensor
//    cores straight from shared memory. Sharing matters most: 64-row
//    blocks, two an SM, fall well behind 128-row ones at equal waves.
// 3. A two-deep pipeline run by the computing warps, two __syncthreads a
//    tile -> warp specialisation: one producer thread (its warpgroup drops
//    to 24 registers with setmaxnreg.dec) keeps a ring of 2-4 K/V stages in
//    flight through full / empty mbarriers, and each consumer
//    (setmaxnreg.inc) overlaps tile j's S = Q K^T and softmax with tile
//    j - 1's O += P V. Consumers never wait on each other, only on the
//    stage they read.
// 4. Poor waves on 132 SMs -> the tile rule (ops/flash_attention.py::
//    wgmma_consumers, from N, H and d only): one consumer a block (two
//    blocks an SM) where 128-row blocks would leave SMs idle (SD1.5's
//    [1,1024,8,80]: 128 blocks instead of 64), three (192 rows) where that
//    takes no more rows per SM (SDXL's [1,1024,20,64]: 120 blocks, one
//    wave, instead of 160 and a 28-block second one), else two.
// Nothing is split over keys and there are no atomics: each block walks its
// rows' keys in one fixed order, so a row's bytes do not depend on the batch,
// on the tile rule or on the run.

#include <cuda.h>

#include <initializer_list>

#include "sm90.cuh"

namespace {

constexpr int kRows = 64;   // query rows per consumer warpgroup (wgmma's M)
constexpr int kProducerRegs = 24;

// One instance: DP = head dim padded to a multiple of 16, NCONS consumer
// warpgroups (1, 2 or 3: 64, 128 or 192 query rows a block). ptxas budgets
// every path of a kernel at its entry count, so the registers a consumer may
// hold are the launch bound's: 128 with one consumer (256 threads, two
// blocks an SM) or three (512 threads), 168 with two (384 threads, one
// block). The pipelined loop holds S, two sets of P and O: with 64-key tiles
// that fits everywhere but at d = 80 in 128 registers, which runs the loop
// unpipelined (ptxas would otherwise serialize the wgmmas).
template <int DP, int NCONS>
struct WgmmaCfg {
  static_assert(DP % 16 == 0 && DP <= 128, "head dim padded to a multiple of 16, <= 128");
  static constexpr int kThreads = 128 * (NCONS + 1);
  static constexpr int kBlocksPerSM = NCONS == 1 ? 2 : 1;
  static constexpr int kEntryRegs = (65536 / (kThreads * kBlocksPerSM)) / 8 * 8;
  // what the producer's warpgroup drops goes to the consumers
  static constexpr int kConsumerRegs = (kEntryRegs * (NCONS + 1) - kProducerRegs) / NCONS / 8 * 8;
  static constexpr int kBK = 64;  // keys per tile
  static constexpr bool kPipelined = NCONS == 2 || DP <= 64;
  static_assert(NCONS != 3 || DP <= 64, "three consumers are built for d <= 64");
  // the swizzle: 128-byte rows (one TMA box of 64 dims) where the head dim
  // is a multiple of 64, else 32-byte rows (boxes of 16 dims)
  static constexpr int kSW = DP % 64 == 0 ? 128 : 32;
  static constexpr int kChunk = kSW / 2;  // head-dim elements per chunk
  static constexpr int kChunks = DP / kChunk;
  static constexpr int kQBytes = kRows * DP * 2;  // one consumer's Q
  static constexpr int kTileBytes = kBK * DP * 2;  // one K or V tile
  // 227 KB a block, or 113 KB for two blocks an SM (228 KB less 1 KB each)
  static constexpr int kSmemBudget = (kBlocksPerSM == 1 ? 227 : 113) * 1024 - 2048;
  static constexpr int kFitStages = (kSmemBudget - NCONS * kQBytes) / (2 * kTileBytes);
  static constexpr int kStages = kFitStages > 4 ? 4 : kFitStages;
  static_assert(kStages >= 2, "the K/V ring needs two stages");
  static constexpr int kBarOffset = NCONS * kQBytes + 2 * kStages * kTileBytes;
  // + 1 KB to align the base to 1024 bytes (the 128-byte swizzle's period)
  static constexpr int kSmemBytes = kBarOffset + (2 * kStages + 1) * 8 + 1024;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int KP>
__device__ __forceinline__ void fence_p(uint32_t (&pa)[KP][4]) {
#pragma unroll
  for (int kp = 0; kp < KP; ++kp) fence_operands(pa[kp]);
}

// S = Q K^T for 64 rows and a BK-key tile, 16 head dims a step (chunk
// ks * 16 / (SW / 2), 32 bytes into its rows per step within it; issued,
// not waited for)
template <int DP, int SW, int BK>
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2], const unsigned char* sqc,
                                         const unsigned char* skt) {
  constexpr int kSteps = SW / 32;  // k16 steps a chunk
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    const int ch = ks / kSteps;
    const int off = (ks % kSteps) * 32;
    wgmma_ss_k16(sc, wgmma_desc<SW>(sqc + ch * kRows * SW + off, 16, 8 * SW),
                 wgmma_desc<SW>(skt + ch * BK * SW + off, 16, 8 * SW), ks);
  }
}

// O += P V for a BK-key tile, 16 keys a step; V's tile through an MN-major
// descriptor (issued, not waited for)
template <int SW, int N, int KP>
__device__ __forceinline__ void issue_pv(float (&acc)[N], const uint32_t (&pa)[KP][4],
                                         const unsigned char* svt) {
#pragma unroll
  for (int kp = 0; kp < KP; ++kp) {
    wgmma_rs_k16(acc, pa[kp], wgmma_desc<SW>(svt + kp * 16 * SW, KP * 16 * SW, 8 * SW));
  }
}

// Online softmax of one tile of raw scores in the log2 domain (rows g and
// g + 8 of the thread: e / 2 of each accumulator quadruple): keys >= m
// masked with the finite -1e30 (RAGGED: the tile crosses m), the row max
// over the quad, p = 2^(s * scale_log2 - max) (one FFMA and ex2), the row
// sum over fp32 p (the Pallas kernel's l_scr update), P rounded to bf16 into
// wgmma's register-A layout. alpha rescales what was accumulated before this
// tile. The scores are only read: a wgmma of the next tile writes them.
template <bool RAGGED, int BK>
__device__ __forceinline__ void softmax_tile(const float (&sc)[BK / 2], uint32_t (&pa)[BK / 16][4],
                                             float (&row_max)[2], float (&row_sum)[2],
                                             float (&alpha)[2], int key0, int m, int t,
                                             float scale_log2) {
  auto score = [&](int i) {
    const int key = key0 + 8 * (i / 4) + 2 * t + (i & 1);
    return RAGGED && key >= m ? kNegInf : sc[i];
  };
  float tile_max[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) tile_max[(i >> 1) & 1] = fmaxf(tile_max[(i >> 1) & 1], score(i));
  float neg_max[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
    tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
    const float new_max = fmaxf(row_max[r], tile_max[r] * scale_log2);
    alpha[r] = ex2(row_max[r] - new_max);
    row_max[r] = new_max;
    row_sum[r] *= alpha[r];
    neg_max[r] = -new_max;
  }
#pragma unroll
  for (int kp = 0; kp < BK / 16; ++kp) {
    float p[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      p[e] = ex2(fmaf(score(8 * kp + e), scale_log2, neg_max[(e >> 1) & 1]));
      row_sum[(e >> 1) & 1] += p[e];
    }
    pa[kp][0] = pack_bf16(p[0], p[1]);  // row g, keys 16kp + 2t
    pa[kp][1] = pack_bf16(p[2], p[3]);  // row g + 8
    pa[kp][2] = pack_bf16(p[4], p[5]);  // row g, keys 16kp + 8 + 2t
    pa[kp][3] = pack_bf16(p[6], p[7]);  // row g + 8
  }
}

template <int BK>
__device__ __forceinline__ void softmax(const float (&sc)[BK / 2], uint32_t (&pa)[BK / 16][4],
                                        float (&row_max)[2], float (&row_sum)[2],
                                        float (&alpha)[2], int key0, int m, int t,
                                        float scale_log2) {
  if (key0 + BK > m) {
    softmax_tile<true, BK>(sc, pa, row_max, row_sum, alpha, key0, m, t, scale_log2);
  } else {
    softmax_tile<false, BK>(sc, pa, row_max, row_sum, alpha, key0, m, t, scale_log2);
  }
}

template <int DP, int NCONS>
__global__ void __launch_bounds__(WgmmaCfg<DP, NCONS>::kThreads,
                                  WgmmaCfg<DP, NCONS>::kBlocksPerSM)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                   int n, int m, int h, int d, float scale_log2) {
  using Cfg = WgmmaCfg<DP, NCONS>;
  constexpr int S = Cfg::kStages;
  constexpr int BK = Cfg::kBK;
  constexpr int KP = BK / 16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sq = base;                      // [NCONS][chunks][64][16]
  unsigned char* sk = sq + NCONS * Cfg::kQBytes;  // [S][chunks][BK][16]
  unsigned char* sv = sk + S * Cfg::kTileBytes;   // [S][chunks][BK][16]
  uint64_t* full = reinterpret_cast<uint64_t*>(base + Cfg::kBarOffset);
  uint64_t* empty = full + S;
  uint64_t* qbar = empty + S;

  const int b = blockIdx.z;
  const int hh = blockIdx.y;
  const int q0 = blockIdx.x * kRows * NCONS;
  const int ntiles = (m + BK - 1) / BK;
  const int wg = threadIdx.x / 128;  // 0: producer

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);           // the producer's arrive + TMA bytes
      mbar_init(&empty[s], 4 * NCONS);  // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------- producer: one thread issues every TMA load ----------
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      mbar_arrive_expect_tx(qbar, NCONS * Cfg::kQBytes);
      for (int c = 0; c < NCONS; ++c) {
        for (int ch = 0; ch < Cfg::kChunks; ++ch) {
          tma_load_4d(sq + c * Cfg::kQBytes + ch * kRows * Cfg::kSW, &tq, qbar,
                      ch * Cfg::kChunk, hh, q0 + c * kRows, b);
        }
      }
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % S;
        mbar_wait(&empty[s], ((it / S) & 1) ^ 1);  // the first round passes at once
        mbar_arrive_expect_tx(&full[s], 2 * Cfg::kTileBytes);
        unsigned char* skt = sk + s * Cfg::kTileBytes;
        unsigned char* svt = sv + s * Cfg::kTileBytes;
        for (int ch = 0; ch < Cfg::kChunks; ++ch) {
          tma_load_4d(skt + ch * BK * Cfg::kSW, &tk, &full[s], ch * Cfg::kChunk, hh, it * BK,
                      b);
        }
        for (int ch = 0; ch < Cfg::kChunks; ++ch) {
          tma_load_4d(svt + ch * BK * Cfg::kSW, &tv, &full[s], ch * Cfg::kChunk, hh, it * BK,
                      b);
        }
      }
    }
  } else {
    // ---------------- consumers: 64 query rows each ----------------------
    setmaxnreg_inc<Cfg::kConsumerRegs>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;  // accumulator rows g and g + 8 of this warp's 16
    const int t = lane % 4;  // accumulator columns 2t, 2t + 1 of each 8
    const unsigned char* sqc = sq + cw * Cfg::kQBytes;

    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    // rows g and g + 8: running max (log2 domain) and this thread's share of the sum
    float row_max[2] = {kNegInf, kNegInf};
    float row_sum[2] = {0.f, 0.f};

    // Tile it's S = Q K^T is issued beside tile it - 1's O += P V, and its
    // softmax runs while that product is on the tensor cores (the per-row
    // arithmetic and its order are those of an unpipelined loop). P
    // alternates between two register sets: a copy from one to the other
    // would make ptxas serialize the wgmmas.
    float sc[BK / 2];
    uint32_t pa[KP][4], pb[KP][4];
    float alpha[2];
    mbar_wait(qbar, 0);
    mbar_wait(&full[0], 0);
    wgmma_fence();
    issue_qk<DP, Cfg::kSW, BK>(sc, sqc, sk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sc);
    softmax<BK>(sc, pa, row_max, row_sum, alpha, 0, m, t, scale_log2);  // acc is still 0

    // tile it: S = Q K^T beside O += P_in V of tile it - 1; its P into p_out
    auto step = [&](int it, uint32_t (&p_in)[KP][4], uint32_t (&p_out)[KP][4]) {
      const int s = it % S;
      const int sp = (it - 1) % S;
      mbar_wait(&full[s], (it / S) & 1);
      fence_operands(sc);
      fence_operands(acc);
      fence_p(p_in);
      wgmma_fence();
      issue_qk<DP, Cfg::kSW, BK>(sc, sqc, sk + s * Cfg::kTileBytes);
      wgmma_commit();
      issue_pv<Cfg::kSW>(acc, p_in, sv + sp * Cfg::kTileBytes);
      wgmma_commit();
      wgmma_wait<1>();  // S of tile it
      fence_operands(sc);
      softmax<BK>(sc, p_out, row_max, row_sum, alpha, it * BK, m, t, scale_log2);
      wgmma_wait<0>();  // O += P V of tile it - 1
      fence_operands(acc);
      fence_p(p_in);  // P stays in its registers until the product has read it
      if (lane == 0) mbar_arrive(&empty[sp]);  // this warp is done with the stage
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        acc[4 * j] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];
      }
    };
    // O += P V of the tile in stage s, waited for
    auto finish = [&](uint32_t (&p)[KP][4], int s) {
      fence_operands(acc);
      fence_p(p);
      wgmma_fence();
      issue_pv<Cfg::kSW>(acc, p, sv + s * Cfg::kTileBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
      fence_p(p);
    };
    if constexpr (Cfg::kPipelined) {
      int it = 1;
      for (; it + 1 < ntiles; it += 2) {
        step(it, pa, pb);
        step(it + 1, pb, pa);
      }
      if (it < ntiles) {
        step(it, pa, pb);
        finish(pb, (ntiles - 1) % S);
      } else {
        finish(pa, (ntiles - 1) % S);
      }
    } else {
      // one tile at a time: S, softmax, O += P V
      for (int it = 1; it < ntiles; ++it) {
        finish(pa, (it - 1) % S);
        if (lane == 0) mbar_arrive(&empty[(it - 1) % S]);
        mbar_wait(&full[it % S], (it / S) & 1);
        wgmma_fence();
        issue_qk<DP, Cfg::kSW, BK>(sc, sqc, sk + (it % S) * Cfg::kTileBytes);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(sc);
        softmax<BK>(sc, pa, row_max, row_sum, alpha, it * BK, m, t, scale_log2);
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          acc[4 * j] *= alpha[0];
          acc[4 * j + 1] *= alpha[0];
          acc[4 * j + 2] *= alpha[1];
          acc[4 * j + 3] *= alpha[1];
        }
      }
      finish(pa, (ntiles - 1) % S);
    }

    // the quad's shares of each row sum, then O / l stored as bf16
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 1);
      row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + cw * kRows + warp * 16 + g + r * 8;
      if (row >= n) continue;
      const float inv = 1.f / row_sum[r];
      bf16* op = o + ((static_cast<int64_t>(b) * n + row) * h + hh) * d;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int c = j * 8 + 2 * t;
        if (c < d) {  // d % 8 == 0: c + 1 < d too
          *reinterpret_cast<__nv_bfloat162*>(op + c) =
              __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side: tensor maps and the launch
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// [B, T, H, D] bf16 with strides (sb, st, sh) in elements and the head dim
// contiguous, as dims {D, H, T, B} (innermost first; strides in bytes grow
// with the dim for every layout the route sends here). A box is one 16-wide
// chunk of the head dim of `rows` tokens of one head: [rows][sw / 2] with
// the sw-byte swizzle; coordinates beyond D or T read as zero.
bool encode_map(CUtensorMap* map, const void* ptr, int b, int tokens, int h, int d,
                const int64_t* s, int rows, int sw) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(tokens), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s[2]) * 2,
                                 static_cast<cuuint64_t>(s[1]) * 2,
                                 static_cast<cuuint64_t>(s[0]) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(sw / 2), 1, static_cast<cuuint32_t>(rows),
                             1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// return codes beside CUDA's own (ops/flash_attention.py names them)
constexpr int kErrUnsupported = -1;
constexpr int kErrTensorMap = -2;
constexpr int kErrRegisters = -3;

template <int DP, int NCONS>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int b, int n, int m,
                 int h, int d, const int64_t* qs, const int64_t* ks, const int64_t* vs,
                 float scale, cudaStream_t stream) {
  using Cfg = WgmmaCfg<DP, NCONS>;
  auto kernel = flash_wgmma_kernel<DP, NCONS>;
  // a kernel entered with fewer registers than setmaxnreg hands out would
  // wait in setmaxnreg.inc for ever: refuse it instead
  static const int setup = [&] {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (attr.numRegs != Cfg::kEntryRegs) return kErrRegisters;
    return static_cast<int>(allow_smem(kernel, Cfg::kSmemBytes));
  }();
  if (setup != 0) return setup;
  CUtensorMap tq, tk, tv;
  if (!encode_map(&tq, q, b, n, h, d, qs, kRows, Cfg::kSW) ||
      !encode_map(&tk, k, b, m, h, d, ks, Cfg::kBK, Cfg::kSW) ||
      !encode_map(&tv, v, b, m, h, d, vs, Cfg::kBK, Cfg::kSW)) {
    return kErrTensorMap;
  }
  const dim3 grid((n + kRows * NCONS - 1) / (kRows * NCONS), h, b);
  kernel<<<grid, Cfg::kThreads, Cfg::kSmemBytes, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), n, m, h, d, scale * kLog2e);
  return 0;
}

template <int NCONS>
int dispatch_dp(const void* q, const void* k, const void* v, void* o, int b, int n, int m,
                int h, int d, const int64_t* qs, const int64_t* ks, const int64_t* vs,
                float scale, cudaStream_t stream) {
#define DL_WGMMA_CASE(DP)                                                                   \
  if (d <= DP) {                                                                            \
    return launch_wgmma<DP, NCONS>(q, k, v, o, b, n, m, h, d, qs, ks, vs, scale, stream);   \
  }
  // d = 40 runs at 48 (TMA fills the rest with zeros); 16, 64, 80 (the UNet's
  // heads and the tiny configs') and 128 (the widest the dispatcher sends)
  // unpadded; one consumer warpgroup takes d <= 80 only (the rule never asks
  // for it at 128)
  DL_WGMMA_CASE(16)
  DL_WGMMA_CASE(48)
  DL_WGMMA_CASE(64)
  if constexpr (NCONS != 3) {
    DL_WGMMA_CASE(80)
  }
  if constexpr (NCONS == 2) {
    DL_WGMMA_CASE(128)
  }
#undef DL_WGMMA_CASE
  return kErrUnsupported;
}

template <int DP, int NCONS>
void describe(int* row) {
  using Cfg = WgmmaCfg<DP, NCONS>;
  const int fields[9] = {DP, NCONS, Cfg::kThreads, Cfg::kBlocksPerSM, Cfg::kEntryRegs,
                         Cfg::kConsumerRegs, Cfg::kBK, Cfg::kStages, Cfg::kSmemBytes};
  for (int i = 0; i < 9; ++i) row[i] = fields[i];
  row[9] = Cfg::kPipelined ? 1 : 0;
}

}  // namespace

// The built instances of flash_wgmma_kernel, ten ints each: padded head dim,
// consumer warpgroups, threads, blocks an SM (the launch bound), registers
// at entry, consumer registers after setmaxnreg, keys per tile, K/V stages,
// dynamic shared memory bytes, pipelined (1) or not. Returns the number of
// instances; writes at most max_rows of them.
extern "C" int dl_flash_wgmma_instances(int* rows, int max_rows) {
  using Fn = void (*)(int*);
  const Fn all[] = {describe<16, 1>, describe<48, 1>, describe<64, 1>, describe<80, 1>,
                    describe<16, 2>, describe<48, 2>, describe<64, 2>, describe<80, 2>,
                    describe<128, 2>, describe<16, 3>, describe<48, 3>, describe<64, 3>};
  const int n = static_cast<int>(sizeof(all) / sizeof(all[0]));
  for (int i = 0; i < n && i < max_rows; ++i) all[i](rows + 10 * i);
  return n;
}

// Returns cudaGetLastError() after the launch, or a negative code: -1 for
// inputs the kernel does not take (dtype bf16 only, d % 8 == 0, d <= 128,
// 16-byte aligned bases, strides multiples of 8 elements, consumers 1 or
// 2), -2 for a tensor map the driver refused, -3 for a build whose register
// count at entry is not the one setmaxnreg was sized for. The Python wrapper
// routes only inputs it takes, and raises on any non-zero return.
extern "C" int dl_flash_wgmma(
    int device, const void* q, const void* k, const void* v, void* o,
    int b, int n, int m, int h, int d, int consumers,
    int64_t q_sb, int64_t q_sn, int64_t q_sh,
    int64_t k_sb, int64_t k_sm, int64_t k_sh,
    int64_t v_sb, int64_t v_sm, int64_t v_sh,
    float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t qs[3] = {q_sb, q_sn, q_sh};
  const int64_t ks[3] = {k_sb, k_sm, k_sh};
  const int64_t vs[3] = {v_sb, v_sm, v_sh};
  bool ok = d % 8 == 0 && d >= 8 && d <= 128 && consumers >= 1 && consumers <= 3;
  for (const void* p : {q, k, v}) ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  for (const int64_t* s : {qs, ks, vs}) {
    for (int i = 0; i < 3; ++i) ok = ok && s[i] > 0 && s[i] % 8 == 0;
  }
  if (!ok) return kErrUnsupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc =
      consumers == 1   ? dispatch_dp<1>(q, k, v, o, b, n, m, h, d, qs, ks, vs, scale, st)
      : consumers == 2 ? dispatch_dp<2>(q, k, v, o, b, n, m, h, d, qs, ks, vs, scale, st)
                       : dispatch_dp<3>(q, k, v, o, b, n, m, h, d, qs, ks, vs, scale, st);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// The consumer warpgroup shared by the port's two wgmma flash kernels,
// csrc/flash_wgmma.cu (K1: one head a block) and csrc/flash_group_wgmma.cu
// (K4 and K6: a group of lane-adjacent heads a block), and their host side:
// the driver's tensor-map encoder and the entry points' return codes.
//
// A consumer owns 64 query rows of one head. Its Q tile and the K/V ring's
// tiles of its head lie in shared memory as the head dim in chunks, each
// chunk a [rows][SW bytes] block under the SW-byte swizzle (csrc/sm90.cuh);
// the template parameters say how far apart the chunks and the stages are,
// which is all the two kernels' layouts differ in. The arithmetic: S = Q K^T
// and O += P V on wgmma.mma_async, exp2 with the scale folded into log2(e),
// keys >= M masked with the finite -1e30, the row sum over fp32 p, P rounded
// to bf16 before the PV product (the Pallas kernels' p.astype(v.dtype)),
// fp32 accumulation, O / l rounded to bf16 once. Each consumer walks its
// keys in one fixed order.
#pragma once

#include <cuda.h>

#include "sm90.cuh"

namespace {

constexpr int kRows = 64;   // query rows per consumer warpgroup (wgmma's M)
constexpr int kProducerRegs = 24;

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
// ks * 16 / (SW / 2), 32 bytes into its rows per step within it; Q's chunks
// Q_CHUNK bytes apart, the tile's KV_CHUNK; issued, not waited for)
template <int DP, int SW, int BK, int Q_CHUNK, int KV_CHUNK>
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2], const unsigned char* sqc,
                                         const unsigned char* skt) {
  constexpr int kSteps = SW / 32;  // k16 steps a chunk
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    const int ch = ks / kSteps;
    const int off = (ks % kSteps) * 32;
    wgmma_ss_k16(sc, wgmma_desc<SW>(sqc + ch * Q_CHUNK + off, 16, 8 * SW),
                 wgmma_desc<SW>(skt + ch * KV_CHUNK + off, 16, 8 * SW), ks);
  }
}

// O += P V for a BK-key tile, 16 keys a step; V's tile through an MN-major
// descriptor whose SW-wide blocks of head dims are KV_CHUNK bytes apart
// (issued, not waited for)
template <int SW, int KV_CHUNK, int N, int KP>
__device__ __forceinline__ void issue_pv(float (&acc)[N], const uint32_t (&pa)[KP][4],
                                         const unsigned char* svt) {
#pragma unroll
  for (int kp = 0; kp < KP; ++kp) {
    wgmma_rs_k16(acc, pa[kp], wgmma_desc<SW>(svt + kp * 16 * SW, KV_CHUNK, 8 * SW));
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

// One consumer warpgroup (after its setmaxnreg.inc): 64 query rows from
// row0 of head `head` of batch row b, against all m keys, into o [B, N, H, d]
// contiguous. sqc: its Q tile (chunks Q_CHUNK bytes apart); sk, sv: its
// head's K and V tiles in stage 0 of the ring (chunks KV_CHUNK bytes apart,
// stages KV_STAGE). full[s] completes when stage s has arrived, empty[s]
// takes one arrival from each consumer warp when it is done with the stage,
// qbar completes when Q has arrived.
//
// Tile it's S = Q K^T is issued beside tile it - 1's O += P V, and its
// softmax runs while that product is on the tensor cores (the per-row
// arithmetic and its order are those of an unpipelined loop); PIPELINED
// false runs one tile at a time. P alternates between two register sets: a
// copy from one to the other would make ptxas serialize the wgmmas.
template <int DP, int SW, int BK, int S, bool PIPELINED, int Q_CHUNK, int KV_CHUNK,
          int KV_STAGE>
__device__ __forceinline__ void flash_consumer(const unsigned char* sqc,
                                               const unsigned char* sk,
                                               const unsigned char* sv, uint64_t* full,
                                               uint64_t* empty, uint64_t* qbar,
                                               bf16* __restrict__ o, int b, int row0, int head,
                                               int n, int m, int h, int d, float scale_log2) {
  constexpr int KP = BK / 16;
  const int ntiles = (m + BK - 1) / BK;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // accumulator rows g and g + 8 of this warp's 16
  const int t = lane % 4;  // accumulator columns 2t, 2t + 1 of each 8

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  // rows g and g + 8: running max (log2 domain) and this thread's share of the sum
  float row_max[2] = {kNegInf, kNegInf};
  float row_sum[2] = {0.f, 0.f};

  float sc[BK / 2];
  uint32_t pa[KP][4], pb[KP][4];
  float alpha[2];
  mbar_wait(qbar, 0);
  mbar_wait(&full[0], 0);
  wgmma_fence();
  issue_qk<DP, SW, BK, Q_CHUNK, KV_CHUNK>(sc, sqc, sk);
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
    issue_qk<DP, SW, BK, Q_CHUNK, KV_CHUNK>(sc, sqc, sk + s * KV_STAGE);
    wgmma_commit();
    issue_pv<SW, KV_CHUNK>(acc, p_in, sv + sp * KV_STAGE);
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
    issue_pv<SW, KV_CHUNK>(acc, p, sv + s * KV_STAGE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    fence_p(p);
  };
  if constexpr (PIPELINED) {
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
      issue_qk<DP, SW, BK, Q_CHUNK, KV_CHUNK>(sc, sqc, sk + (it % S) * KV_STAGE);
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
    const int row = row0 + warp * 16 + g + r * 8;
    if (row >= n) continue;
    const float inv = 1.f / row_sum[r];
    bf16* op = o + ((static_cast<int64_t>(b) * n + row) * h + head) * d;
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

// ---------------------------------------------------------------------------
// host side
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

// A 4-d bf16 tensor map (dims and box innermost first, the innermost dim
// contiguous; the three outer strides in elements) whose boxes land in
// shared memory under the sw-byte swizzle; coordinates beyond a dim read as
// zero.
bool encode_bf16_map(CUtensorMap* map, const void* ptr, const uint64_t (&dims)[4],
                     const int64_t (&strides)[3], const uint32_t (&box)[4], int sw) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t gdims[4];
  cuuint32_t gbox[4];
  cuuint64_t gstrides[3];
  for (int i = 0; i < 4; ++i) {
    gdims[i] = dims[i];
    gbox[i] = box[i];
  }
  for (int i = 0; i < 3; ++i) gstrides[i] = static_cast<cuuint64_t>(strides[i]) * 2;
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), gdims,
                gstrides, gbox, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// return codes beside CUDA's own (ops/flash_attention.py and
// ops/flash_group.py name them)
constexpr int kErrUnsupported = -1;
constexpr int kErrTensorMap = -2;
constexpr int kErrRegisters = -3;

// A warp-specialised kernel entered with fewer registers than setmaxnreg
// hands out would wait in setmaxnreg.inc for ever: 0 where ptxas gave it
// `entry_regs` and its shared memory limit is raised, else the error (once
// per instance: callers keep the result in a function-local static)
template <typename Kernel>
int setup_wgmma(Kernel* kernel, int entry_regs, size_t smem_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (attr.numRegs != entry_regs) return kErrRegisters;
  return static_cast<int>(allow_smem(kernel, smem_bytes));
}

}  // namespace

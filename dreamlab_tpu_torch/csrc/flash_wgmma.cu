// Flash attention for Hopper (sm_90a), bf16: non-causal softmax(Q K^T * scale) V
// with wgmma, TMA and a warp-specialised pipeline.
//
// Replaces the Pallas TPU kernel dreamlab_tpu/ops/flash_attention.py::_flash_kernel
// (launched by flash_attention() through pl.pallas_call) for bf16 inputs that
// TMA can describe; ops/flash_attention.py::route says which, and
// ops/attention.py sends any other bf16 call to the plain path.
//
// What it computes: q [B, N, H, D], k/v [B, M, H, D] in bf16, read in place
// through their strides (the packed projection's views included: token
// stride 3*H*D) -> o [B, N, H, D] contiguous bf16. The arithmetic: fp32 scores, exp2 with the scale folded into log2(e),
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
// The design, against what held back the mma.sync kernel it replaced:
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
// The consumer warpgroups' loop is csrc/flash_sm90.cuh's flash_consumer,
// shared with the head-group kernel (csrc/flash_group_wgmma.cu).
// Nothing is split over keys and there are no atomics: each block walks its
// rows' keys in one fixed order, so a row's bytes do not depend on the batch,
// on the tile rule or on the run.

#include <initializer_list>

#include "flash_sm90.cuh"

namespace {

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

template <int DP, int NCONS>
__global__ void __launch_bounds__(WgmmaCfg<DP, NCONS>::kThreads,
                                  WgmmaCfg<DP, NCONS>::kBlocksPerSM)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                   int n, int m, int h, int d, float scale_log2) {
  using Cfg = WgmmaCfg<DP, NCONS>;
  constexpr int S = Cfg::kStages;
  constexpr int BK = Cfg::kBK;
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
    flash_consumer<DP, Cfg::kSW, BK, S, Cfg::kPipelined, kRows * Cfg::kSW, BK * Cfg::kSW,
                   Cfg::kTileBytes>(sq + cw * Cfg::kQBytes, sk, sv, full, empty, qbar, o, b,
                                    q0 + cw * kRows, hh, n, m, h, d, scale_log2);
  }
}

// ---------------------------------------------------------------------------
// host side: tensor maps and the launch
// ---------------------------------------------------------------------------

// [B, T, H, D] bf16 with strides (sb, st, sh) in elements and the head dim
// contiguous, as dims {D, H, T, B}. A box is one chunk of the head dim of
// `rows` tokens of one head: [rows][sw / 2] with the sw-byte swizzle;
// coordinates beyond D or T read as zero.
bool encode_map(CUtensorMap* map, const void* ptr, int b, int tokens, int h, int d,
                const int64_t* s, int rows, int sw) {
  const uint64_t dims[4] = {static_cast<uint64_t>(d), static_cast<uint64_t>(h),
                            static_cast<uint64_t>(tokens), static_cast<uint64_t>(b)};
  const int64_t strides[3] = {s[2], s[1], s[0]};
  const uint32_t box[4] = {static_cast<uint32_t>(sw / 2), 1, static_cast<uint32_t>(rows), 1};
  return encode_bf16_map(map, ptr, dims, strides, box, sw);
}

template <int DP, int NCONS>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int b, int n, int m,
                 int h, int d, const int64_t* qs, const int64_t* ks, const int64_t* vs,
                 float scale, cudaStream_t stream) {
  using Cfg = WgmmaCfg<DP, NCONS>;
  auto kernel = flash_wgmma_kernel<DP, NCONS>;
  static const int setup = setup_wgmma(kernel, Cfg::kEntryRegs, Cfg::kSmemBytes);
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

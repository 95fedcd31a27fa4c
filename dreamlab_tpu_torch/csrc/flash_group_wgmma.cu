// Head-group flash attention for Hopper (sm_90a), bf16: non-causal
// softmax(Q K^T * scale) V where one block owns PACK lane-adjacent heads,
// with wgmma, TMA and a warp-specialised pipeline.
//
// Replaces two Pallas TPU kernels of the layout probes for bf16 inputs that
// TMA can describe (ops/flash_group.py::route says which):
//   scripts/ab_transpose_free.py::flash_attention_4d (K1's _flash_kernel run
//     through a 4-D BlockSpec over [B, N, G, L], pack heads per grid step);
//   scripts/ab_head_packing.py::_packed3_kernel (3 heads per 128-lane block,
//     launched by flash_attention_packed3).
//
// What it computes: q [B, N, H, D], k/v [B, M, H, D] in bf16, read in place
// through their strides -> o [B, N, H, D] contiguous bf16. Group g is heads
// [g*PACK, (g+1)*PACK). The arithmetic is K1's wgmma kernel's, in the same
// consumer loop (csrc/flash_sm90.cuh::flash_consumer): fp32 scores, exp2
// with the scale folded into log2(e), keys >= M masked with the finite
// -1e30, the row sum over fp32 p, P rounded to bf16 before the PV product
// (the Pallas kernels' p.astype(v.dtype)), fp32 accumulation, O / l rounded
// to bf16 once.
//
// What bounds it on this card: 4*B*H*N*M*D tensor-core operations on
// B*H*(2N + 2M)*D elements, far above the H100's ~295 operations per byte,
// so the bound is arithmetic at 989 TFLOP/s: 0.217 ms for a K4 probe run
// ([8,4096,6,40] and [2,4096,10,64]), 0.130 ms for K6 ([8,4096,6,40]).
//
// The design, against what held back the mma.sync group kernel it replaced:
// 1. Ampere instructions (mma.sync, cp.async, ldmatrix, two __syncthreads a
//    tile run by the computing warps) -> Hopper's: both products on
//    wgmma.mma_async, P in registers as wgmma's A operand, V through an
//    MN-major descriptor, tiles by TMA into a ring of 4 K/V stages that one
//    producer thread keeps in flight through full / empty mbarriers, and
//    each consumer overlapping tile j's S = Q K^T and softmax with tile
//    j - 1's O += P V.
// 2. One K/V tile fill for the whole group, the head group's point on the
//    TPU: one TMA box per chunk of the head dim (64 dims, 128-byte rows, at
//    DP 64; 16 dims, 32-byte rows, at DP 16) brings that chunk of all PACK
//    heads at once. The tensor maps run over (d, tokens, heads, batch), the
//    box over (chunk, 64 tokens, PACK heads, 1), so each head's [64][chunk]
//    tile lands contiguous under the swizzle, at a multiple of the
//    swizzle's period, exactly as K1's one-head box lays it out; the wgmma
//    descriptors read it unchanged, only the chunk stride grows PACK times.
//    d = 40 is zero-filled to DP 64 by TMA's out-of-bounds fill along the
//    head dim, so a head never reads its neighbour's dims, and no copy pads
//    anything; the key and query edges are filled the same way. DP 64, not
//    the mma depth's 48: TMA's time goes by the rows it fetches, and at 48
//    the head dim takes three 32-byte rows a token where 64 takes one
//    128-byte row, which outweighs the products' extra k- and n-steps
//    (PERF.md, the K6 probe at both depths).
// 3. Consumer warpgroup c takes head c of the group, 64 query rows: PACK
//    consumers and the producer's warpgroup make 384 threads at pack 2
//    (168 registers at entry, 240 a consumer after setmaxnreg) and 512 at
//    pack 3 (128 and 160), one block an SM. A consumer holding 128 rows
//    would need about twice the S, P and O registers, which neither budget
//    has: ptxas budgets every path at the entry count (PERF.md).
//    The launch refuses a build whose entry registers differ from what
//    setmaxnreg was sized for, and a lost mbarrier arrival traps instead of
//    hanging the card (csrc/sm90.cuh::mbar_wait).
// What the group cannot share: each consumer reads its own head's K and V,
// so a block moves PACK heads' tiles into shared memory for 64 rows each,
// where K1's 2-3 consumers share one head's tiles among 128-192 rows.
// Nothing is split over keys and there are no atomics: each block walks its
// rows' keys in one fixed order, so a batch row gives the bytes of its solo
// run.

#include <initializer_list>

#include "flash_sm90.cuh"

namespace {

// One instance: PACK heads a block, DP = 16 or 64, the head dim
// zero-filled to it. One block an SM at the register file's share of its
// threads.
template <int PACK, int DP>
struct GroupCfg {
  static_assert(PACK == 2 || PACK == 3, "groups of 2 or 3 heads");
  static_assert(DP == 16 || DP == 64, "head dim zero-filled to 16 or 64");
  static constexpr int kThreads = 128 * (PACK + 1);
  static constexpr int kEntryRegs = (65536 / kThreads) / 8 * 8;
  // what the producer's warpgroup drops goes to the consumers
  static constexpr int kConsumerRegs = (kEntryRegs * (PACK + 1) - kProducerRegs) / PACK / 8 * 8;
  static constexpr int kBK = 64;  // keys per tile
  static constexpr int kSW = DP % 64 == 0 ? 128 : 32;
  static constexpr int kChunk = kSW / 2;  // head-dim elements per chunk
  static constexpr int kChunks = DP / kChunk;
  static constexpr int kQHead = kRows * kSW;    // one head's Q rows of one chunk
  static constexpr int kKVHead = kBK * kSW;     // one head's K (or V) rows of one chunk
  static constexpr int kQChunk = PACK * kQHead;   // one TMA box of Q
  static constexpr int kKVChunk = PACK * kKVHead;  // one TMA box of K or V
  static constexpr int kQBytes = kChunks * kQChunk;
  static constexpr int kTileBytes = kChunks * kKVChunk;  // one stage's K (or V), all heads
  static constexpr int kSmemBudget = 227 * 1024 - 2048;
  static constexpr int kFitStages = (kSmemBudget - kQBytes) / (2 * kTileBytes);
  static constexpr int kStages = kFitStages > 4 ? 4 : kFitStages;
  static_assert(kStages >= 2, "the K/V ring needs two stages");
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kTileBytes;
  // + 1 KB to align the base to 1024 bytes (the 128-byte swizzle's period)
  static constexpr int kSmemBytes = kBarOffset + (2 * kStages + 1) * 8 + 1024;
};

template <int PACK, int DP>
__global__ void __launch_bounds__(GroupCfg<PACK, DP>::kThreads, 1)
flash_group_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                         int n, int m, int h, int d, float scale_log2) {
  using Cfg = GroupCfg<PACK, DP>;
  constexpr int S = Cfg::kStages;
  constexpr int BK = Cfg::kBK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sq = base;                     // [chunks][PACK][64][SW]
  unsigned char* sk = sq + Cfg::kQBytes;        // [S][chunks][PACK][BK][SW]
  unsigned char* sv = sk + S * Cfg::kTileBytes;  // [S][chunks][PACK][BK][SW]
  uint64_t* full = reinterpret_cast<uint64_t*>(base + Cfg::kBarOffset);
  uint64_t* empty = full + S;
  uint64_t* qbar = empty + S;

  const int b = blockIdx.z;
  const int h0 = blockIdx.y * PACK;  // the group's first head
  const int q0 = blockIdx.x * kRows;
  const int ntiles = (m + BK - 1) / BK;
  const int wg = threadIdx.x / 128;  // 0: producer

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);          // the producer's arrive + TMA bytes
      mbar_init(&empty[s], 4 * PACK);  // one arrival per consumer warp
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
      mbar_arrive_expect_tx(qbar, Cfg::kQBytes);
      for (int ch = 0; ch < Cfg::kChunks; ++ch) {
        tma_load_4d(sq + ch * Cfg::kQChunk, &tq, qbar, ch * Cfg::kChunk, q0, h0, b);
      }
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % S;
        mbar_wait(&empty[s], ((it / S) & 1) ^ 1);  // the first round passes at once
        mbar_arrive_expect_tx(&full[s], 2 * Cfg::kTileBytes);
        unsigned char* skt = sk + s * Cfg::kTileBytes;
        unsigned char* svt = sv + s * Cfg::kTileBytes;
        for (int ch = 0; ch < Cfg::kChunks; ++ch) {
          tma_load_4d(skt + ch * Cfg::kKVChunk, &tk, &full[s], ch * Cfg::kChunk, it * BK, h0,
                      b);
        }
        for (int ch = 0; ch < Cfg::kChunks; ++ch) {
          tma_load_4d(svt + ch * Cfg::kKVChunk, &tv, &full[s], ch * Cfg::kChunk, it * BK, h0,
                      b);
        }
      }
    }
  } else {
    // ---------------- consumers: head wg - 1 of the group, 64 rows each ---
    setmaxnreg_inc<Cfg::kConsumerRegs>();
    const int c = wg - 1;
    flash_consumer<DP, Cfg::kSW, BK, S, true, Cfg::kQChunk, Cfg::kKVChunk, Cfg::kTileBytes>(
        sq + c * Cfg::kQHead, sk + c * Cfg::kKVHead, sv + c * Cfg::kKVHead, full, empty, qbar,
        o, b, q0, h0 + c, n, m, h, d, scale_log2);
  }
}

// ---------------------------------------------------------------------------
// host side: tensor maps and the launch
// ---------------------------------------------------------------------------

// [B, T, H, D] bf16 with strides (sb, st, sh) in elements and the head dim
// contiguous, as dims {D, T, H, B}. A box is one chunk of the head dim of
// `rows` tokens of `pack` heads: [pack][rows][sw / 2] with the sw-byte
// swizzle; coordinates beyond D or T read as zero.
bool encode_group_map(CUtensorMap* map, const void* ptr, int b, int tokens, int h, int d,
                      const int64_t* s, int rows, int pack, int sw) {
  const uint64_t dims[4] = {static_cast<uint64_t>(d), static_cast<uint64_t>(tokens),
                            static_cast<uint64_t>(h), static_cast<uint64_t>(b)};
  const int64_t strides[3] = {s[1], s[2], s[0]};
  const uint32_t box[4] = {static_cast<uint32_t>(sw / 2), static_cast<uint32_t>(rows),
                           static_cast<uint32_t>(pack), 1};
  return encode_bf16_map(map, ptr, dims, strides, box, sw);
}

template <int PACK, int DP>
int launch_group(const void* q, const void* k, const void* v, void* o, int b, int n, int m,
                 int h, int d, const int64_t* qs, const int64_t* ks, const int64_t* vs,
                 float scale, cudaStream_t stream) {
  using Cfg = GroupCfg<PACK, DP>;
  auto kernel = flash_group_wgmma_kernel<PACK, DP>;
  static const int setup = setup_wgmma(kernel, Cfg::kEntryRegs, Cfg::kSmemBytes);
  if (setup != 0) return setup;
  CUtensorMap tq, tk, tv;
  if (!encode_group_map(&tq, q, b, n, h, d, qs, kRows, PACK, Cfg::kSW) ||
      !encode_group_map(&tk, k, b, m, h, d, ks, Cfg::kBK, PACK, Cfg::kSW) ||
      !encode_group_map(&tv, v, b, m, h, d, vs, Cfg::kBK, PACK, Cfg::kSW)) {
    return kErrTensorMap;
  }
  const dim3 grid((n + kRows - 1) / kRows, h / PACK, b);
  kernel<<<grid, Cfg::kThreads, Cfg::kSmemBytes, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), n, m, h, d, scale * kLog2e);
  return 0;
}

template <int PACK, int DP>
void describe(int* row) {
  using Cfg = GroupCfg<PACK, DP>;
  const int fields[8] = {PACK, DP, Cfg::kThreads, Cfg::kEntryRegs, Cfg::kConsumerRegs,
                         Cfg::kBK, Cfg::kStages, Cfg::kSmemBytes};
  for (int i = 0; i < 8; ++i) row[i] = fields[i];
}

}  // namespace

// The built instances of flash_group_wgmma_kernel, eight ints each: heads a
// group, padded head dim, threads (one block an SM), registers at entry,
// consumer registers after setmaxnreg, keys per tile, K/V stages, dynamic
// shared memory bytes. Returns the number of instances; writes at most
// max_rows of them.
extern "C" int dl_flash_group_wgmma_instances(int* rows, int max_rows) {
  using Fn = void (*)(int*);
  const Fn all[] = {describe<2, 16>, describe<2, 64>, describe<3, 16>, describe<3, 64>};
  const int n = static_cast<int>(sizeof(all) / sizeof(all[0]));
  for (int i = 0; i < n && i < max_rows; ++i) all[i](rows + 8 * i);
  return n;
}

// Returns cudaGetLastError() after the launch, or a negative code: -1 for
// inputs the kernel does not take (pack 2 or 3, 8 <= d <= 64, d % 8 == 0,
// h % pack == 0, 16-byte aligned bases, strides positive multiples of 8
// elements), -2 for a tensor map the driver refused, -3 for a build whose
// register count at entry is not the one setmaxnreg was sized for. The
// Python wrapper routes only inputs it takes, and raises on any non-zero
// return.
extern "C" int dl_flash_group_wgmma(
    int device, const void* q, const void* k, const void* v, void* o, int pack,
    int b, int n, int m, int h, int d,
    int64_t q_sb, int64_t q_sn, int64_t q_sh,
    int64_t k_sb, int64_t k_sm, int64_t k_sh,
    int64_t v_sb, int64_t v_sm, int64_t v_sh,
    float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t qs[3] = {q_sb, q_sn, q_sh};
  const int64_t ks[3] = {k_sb, k_sm, k_sh};
  const int64_t vs[3] = {v_sb, v_sm, v_sh};
  bool ok = (pack == 2 || pack == 3) && h % pack == 0 && d % 8 == 0 && d >= 8 && d <= 64;
  for (const void* p : {q, k, v}) ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  for (const int64_t* s : {qs, ks, vs}) {
    for (int i = 0; i < 3; ++i) ok = ok && s[i] > 0 && s[i] % 8 == 0;
  }
  if (!ok) return kErrUnsupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // d <= 16 (the small tests) at DP 16, else at 64: d = 40 takes one
  // 128-byte row a token and head, TMA filling the rest with zeros
  const int dp = d <= 16 ? 16 : 64;
#define DL_GROUP_CASE(P, DP)                                                               \
  if (pack == P && dp == DP) {                                                             \
    const int rc = launch_group<P, DP>(q, k, v, o, b, n, m, h, d, qs, ks, vs, scale, st);  \
    return rc != 0 ? rc : static_cast<int>(cudaGetLastError());                            \
  }
  DL_GROUP_CASE(2, 16)
  DL_GROUP_CASE(2, 64)
  DL_GROUP_CASE(3, 16)
  DL_GROUP_CASE(3, 64)
#undef DL_GROUP_CASE
  return kErrUnsupported;
}

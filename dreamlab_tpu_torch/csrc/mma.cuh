// Tensor-core building blocks of the port's bf16 flash attention kernels,
// shared by csrc/flash_attention.cu (flash_mma_kernel: one head per block)
// and csrc/flash_group.cu (flash_group_mma_kernel: a group of lane-adjacent
// heads per block): 16-byte cp.async, ldmatrix, mma.sync m16n8k16 with bf16
// operands and fp32 accumulators, the staging of token rows into shared
// memory, and the shared-memory size and limit of a block.
#pragma once

#include "common.cuh"

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // finite mask value, as in the Pallas kernel
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; valid == false zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values as a bf16 pair, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Stage rows [row0, row0 + ROWS) of HEADS lane-adjacent heads into shared
// memory: in a token row of `src` (rows `stride` elements apart) head j's
// dims start j * d elements in; dim c of head j in row r lands at
// dst[r * LD + j * DP + c]. Rows at or beyond `nrows` and dims at or beyond d
// are zero. vec: 16-byte cp.async copies (every row start 16-byte aligned
// and d % 8 == 0); else element by element.
template <int ROWS, int HEADS, int DP, int LD, int NT>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src, int64_t stride,
                                           int row0, int nrows, int d, bool vec) {
  if (vec) {
    constexpr int CHUNKS = DP / 8;  // per head
    for (int i = threadIdx.x; i < ROWS * HEADS * CHUNKS; i += NT) {
      const int r = i / (HEADS * CHUNKS);
      const int rem = i - r * (HEADS * CHUNKS);
      const int j = HEADS == 1 ? 0 : rem / CHUNKS;
      const int c = (rem - j * CHUNKS) * 8;
      const bool valid = row0 + r < nrows && c < d;
      cp_async16(dst + r * LD + j * DP + c,
                 valid ? src + static_cast<int64_t>(row0 + r) * stride + j * d + c : src,
                 valid);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * HEADS * DP; i += NT) {
      const int r = i / (HEADS * DP);
      const int rem = i - r * (HEADS * DP);
      const int j = HEADS == 1 ? 0 : rem / DP;
      const int c = rem - j * DP;
      bf16 val = __float2bfloat16(0.f);
      if (row0 + r < nrows && c < d) {
        val = src[static_cast<int64_t>(row0 + r) * stride + j * d + c];
      }
      dst[r * LD + j * DP + c] = val;
    }
  }
}

// Dynamic shared memory of a bf16 flash block: BQ query rows and a
// double-buffered K/V ring of BK-key tiles, each row HEADS heads of DP dims
// plus 16 bytes (so that the row pitch is an odd multiple of 16 bytes and
// ldmatrix reads no bank twice).
template <int HEADS, int DP, int BQ, int BK>
constexpr size_t flash_smem_bytes() {
  return static_cast<size_t>(BQ + 4 * BK) * (HEADS * DP + 8) * sizeof(bf16);
}

// Raise a kernel's dynamic shared-memory limit where it needs more than the
// default 48 KB. Callers keep the result in a function-local static, so it
// runs once per kernel instance.
template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

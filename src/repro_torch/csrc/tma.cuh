// Hopper building blocks shared by the TMA-fed wgmma kernels (K2's bf16
// path and K11 in flash_attn.cu, K10 in flash_partial.cu): mbarriers, 4-D
// TMA tile loads, wgmma descriptors and fences, a one-instruction 2^x, and
// the host side's tensor-map encoding.
//
// cuTensorMapEncodeTiled comes from the driver through
// cudaGetDriverEntryPoint, so the library links without -lcuda.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// returns once the barrier's phase of this parity has completed; traps
// after 10 s, so that a protocol fault ends the launch instead of hanging
// the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t since = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    if (since == 0) since = now;
    else if (now - since > 10000000000ull) __trap();
  }
}

// one box of a 4-D map at coordinates (c0 innermost .. c3) into shared
// memory at dst; completion is reported to `bar` as bytes
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
        "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptors for the 128-byte swizzle (layout type 1):
// start address >> 4 in bits 0-13, LBO >> 4 in 16-29, SBO >> 4 in 32-45.
// K-major: rows of 128 bytes, 8-row groups SBO = 1024 bytes apart (LBO is
// not read); a step along K inside the swizzle atom adds its bytes to the
// start address.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// pins the accumulator registers after wait_group, so no read of them is
// scheduled before the asynchronous product has written them
template <int N> __device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// 2^x in one MUFU op (flushes subnormal results to 0; -inf gives 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------- host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-D map over a contiguous array of `type` (2 or 4 bytes an element)
// whose extents, innermost first, are dims[0..3], read in boxes of
// box[0..3] with the 128-byte swizzle (box[0] elements must fill 128
// bytes).  Reads past an edge are zeros.  A nonzero `outer_stride` gives
// the bytes between steps of dims[3] instead (K11 walks a pool row's
// blocks, whose payload holds more than the mapped leaf); it must be a
// multiple of 16.
bool make_map(CUtensorMap* map, EncodeTiled encode, CUtensorMapDataType type,
              const void* base, const long long (&dims)[4],
              const int (&box)[4], long long outer_stride = 0) {
  const cuuint64_t elem = type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
  cuuint64_t extent[4], strides[3];
  cuuint32_t boxes[4];
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  cuuint64_t stride = elem;
  for (int i = 0; i < 4; ++i) {
    extent[i] = static_cast<cuuint64_t>(dims[i]);
    boxes[i] = static_cast<cuuint32_t>(box[i]);
    if (i > 0) strides[i - 1] = stride;
    stride *= extent[i];
  }
  if (outer_stride) strides[2] = static_cast<cuuint64_t>(outer_stride);
  return encode(map, type, 4, const_cast<void*>(base), extent, strides, boxes,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

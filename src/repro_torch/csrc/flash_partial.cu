// K10: one ring step's partial causal attention, unnormalised, on TF32
// tensor cores in split precision.
//
// Replaces repro/kernels/ishmem_device.py::flash_partial (the Pallas
// kernel _flash_partial_kernel behind sequence-parallel ring attention).
// q: (B, Sq, H, hd) is the local query shard at absolute position q_off;
// k, v: (B, Skv, H, hd) are the resident key/value shard at absolute
// position k_off.  Outputs, all f32: acc (B, Sq, H, hd), the UNNORMALISED
// accumulator, and the softmax state m, l (B, Sq, H), so that partials of
// different shards merge by the online-softmax combination.
//
// Arithmetic follows the reference: q is scaled by hd^-0.5 in f32 before
// the dot, a key is visible when its absolute position kpos <= qpos
// (causality is global, not shard-local), masked scores are -1e30, and the
// running max m, the correction exp(m - m_new), l and acc update once per
// key tile.  A row that sees no key of the shard therefore ends as in the
// reference: m = -1e30, l = the number of keys, acc = the sum of v rows
// (merge_partials discards it, since exp(m - m*) underflows to 0).  Keys
// past Skv in the ragged last tile score -inf instead, so they add exactly
// 0 even to such a row.
//
// Bound: operations.  At the ring's shapes (Sq = Skv = 4096, H = 32,
// hd = 128, f32) the causal QK^T and PV products dominate the bytes, and
// the partial is held to the reference's f32 tolerance of 2e-5, which one
// bf16 or TF32 product per term cannot meet.  Split precision can: every
// operand x is written as hi + lo, hi = x rounded to TF32
// (cvt.rna.tf32.f32) and lo = x - hi rounded again, so hi + lo = x within
// 2^-22 relative and both parts are exact TF32 operands.  Each matrix
// product is then three TF32 products, hi.hi + hi.lo + lo.hi, accumulated
// in f32 (lo.lo, about 2^-22 of the product, is dropped).  The bound of
// this design is three times the unmasked products at 495 TFLOP/s (dense
// TF32), against 67 TFLOP/s for plain f32 FMA.  bf16 inputs convert to
// TF32 exactly, so their K and V have no low part, and the kernel skips
// those two products and loads.
//
// Two kernels per call:
//  - split_rows / split_vt (the split pass): q * scale and k into hi/lo
//    planes of their own layout, (2, B, S, H, hd), hi then lo; v
//    TRANSPOSED into (2, B, H, hd, Skv8), Skv rounded up to 8 with zero
//    keys.  wgmma takes TF32 operands K-major only (no transpose flag, as
//    16-bit types have), and P.V contracts over keys, so V^T is what its B
//    operand needs.  Within each group of 8 keys, position i holds key
//    0, 2, 4, 6, 1, 3, 5, 7 (see below).  It moves about 0.6 GB per call at
//    the ring's shapes;
//  - flash_partial_tf32: one CTA per (q tile of 64 rows, head, batch): one
//    consumer warpgroup runs wgmma, one producer thread (warp 4) issues
//    every TMA load.  q hi/lo is loaded once; K hi/lo and V^T hi/lo tiles
//    of 32 keys go through a ring of two stages with mbarrier completion
//    (K and V on separate barriers, so Q.K^T starts while V lands).  Every
//    tile is 128-byte rows of 32 f32 (the 128-byte swizzle atom), so one
//    k8 step is 32 bytes along a row, as a k16 step of bf16 in K2.
//    Shared memory at hd = 128: q hi + lo 2 x 32 KB, each stage K hi + lo
//    2 x 16 KB and V^T hi + lo 2 x 16 KB, two stages: 192 KB of the 227 KB
//    a CTA may hold (96 KB at hd = 64, two CTAs an SM; 49 KB at hd = 32,
//    one box a row);
//  - hd = 80 (zamba2's attention width) keeps the global width 80 in the
//    q and K maps and pads their tiles to three 32-column boxes: the third
//    holds columns 64..79 and TMA's zero fill past them (the maps' inner
//    extent is 80, so no byte of the next head is read; a row of 320 bytes
//    keeps every stride on TMA's 16-byte grid).  Q.K^T runs the 10 k8
//    steps of the real columns, P.V is m64n80k8 over V^T's 80 rows, which
//    the split pass writes unpadded.  Shared memory: q 2 x 24 KB, a stage
//    2 x 12 KB + 2 x 10 KB, 137 KB in all;
//  - S = Qhi.Khi + Qlo.Khi + Qhi.Klo is wgmma m64n32k8 .tf32 with both
//    operands K-major in shared memory; masking and the online softmax run
//    in f32 registers.  s - m is its own subtraction before 2^x (one MUFU
//    ex2 of (s - m) log2 e): for a row that sees no key s = m = -1e30, and
//    folding the max into one FFMA with the scale, as K2 does, would leave
//    a rounding residual of about 1e23 instead of the 0 whose 2^0 = 1
//    keeps l = Skv and acc = sum v;
//  - O += Phi.Vhi + Plo.Vhi + Phi.Vlo is wgmma m64n{hd}k8 with P from
//    registers.  The S accumulator gives thread t of a quad keys 2t and
//    2t + 1 of each group of 8; the TF32 A fragment wants k = t and t + 4.
//    With V^T's keys stored as 0, 2, 4, 6, 1, 3, 5, 7, accumulator
//    registers (0, 2, 1, 3) of each 8-key group are the fragment as they
//    stand: P is split in place, with no shuffle;
//  - a q tile whose first query already sees the shard's first key stops
//    at its last query's causal limit: the key tiles after it would add
//    exactly 0 to rows that hold a real running max.  Any other tile walks
//    every key tile, so rows that see no key get the reference's values.
//    Tiles wholly visible skip the mask.  q tiles launch heaviest first.
// Determinism: no atomics and no split over keys, so one run gives the bits
// of the next.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per CTA: one consumer warpgroup
constexpr int kBK = 32;        // keys per tile: one 128-byte row of V^T
constexpr int kStages = 2;     // K/V ring depth
constexpr int kThreads = 160;  // warpgroup 0 consumes; warp 4 produces
constexpr int kConsumers = 128;
constexpr int kCols = 32;      // f32 columns of one 128-byte swizzle row
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// q and K tiles are whole 32-column boxes: hd = 80 pads to 96 columns,
// which TMA fills with zeros past the maps' extent of 80; V^T's tile has
// one 128-byte row per real head dim
template <int HD> struct Tiles {
  static_assert(HD % 8 == 0 && HD <= 256, "wgmma takes N a multiple of 8");
  static constexpr int kBoxes = (HD + kCols - 1) / kCols;
  static constexpr int kPad = kBoxes * kCols;
  static constexpr int kQ = kBQ * kPad * 4;   // q hi (or lo)
  static constexpr int kK = kBK * kPad * 4;   // one K hi (or lo) tile
  static constexpr int kV = HD * kBK * 4;     // one V^T hi (or lo) tile
  static_assert(kV % 1024 == 0, "V^T tiles must keep the swizzle atom");
  static constexpr int kStage = 2 * kK + 2 * kV;
  static constexpr int kDynamic = 2 * kQ + kStages * kStage + 1024;  // + align
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// x rounded to TF32, ties away from zero: the low 13 bits cleared
__device__ __forceinline__ float tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// ---------------------------------------------------------------- split pass

// hi[i] = tf32(x[i] * scale), lo[i] = tf32(x[i] * scale - hi[i])
template <typename T>
__global__ void __launch_bounds__(256)
split_rows(const T* __restrict__ x, float* __restrict__ hi,
           float* __restrict__ lo, long long n, float scale) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += step) {
    const float y = __fmul_rn(to_f(x[i]), scale);  // rounded: never an FMA
    const float h = tf32(y);
    hi[i] = h;
    lo[i] = tf32(y - h);
  }
}

// position i of a group of 8 keys in V^T holds key kperm(i)
__device__ __forceinline__ int kperm(int i) { return i < 4 ? 2 * i : 2 * i - 7; }

// v (B, Skv, H, HD) -> vt (2, B, H, HD, Skv8), hi plane then lo plane; one
// CTA per 32 keys x 32 head dims of one (batch, head), through a padded
// shared tile so that both the reads and the writes are coalesced.  The
// last block of head dims is partial when HD is not a multiple of 32
// (hd = 80: dims 64..79).
template <typename T>
__global__ void __launch_bounds__(256)
split_vt(const T* __restrict__ v, float* __restrict__ vt, int B, int Skv,
         int Skv8, int H, int HD) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32, d0 = blockIdx.y * 32, bh = blockIdx.z;
  const int b = bh / H, h = bh % H;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int r = ty; r < 32; r += 8) {
    const int key = k0 + r;
    tile[r][tx] = key < Skv && d0 + tx < HD
        ? to_f(v[((static_cast<long long>(b) * Skv + key) * H + h) * HD + d0 + tx])
        : 0.f;
  }
  __syncthreads();
  const int pos = k0 + tx;
  if (pos >= Skv8) return;
  const int src = (tx & ~7) | kperm(tx & 7);
  const long long plane = static_cast<long long>(B) * H * HD * Skv8;
  for (int r = ty; r < 32 && d0 + r < HD; r += 8) {
    const float y = tile[src][r];
    const float hi = tf32(y);
    const long long o = (static_cast<long long>(bh) * HD + d0 + r) * Skv8 + pos;
    vt[o] = hi;
    vt[plane + o] = tf32(y - hi);
  }
}

// ---------------------------------------------------------------- wgmma

// d[0:16] (+)= A(desc, K-major) . B(desc, K-major), m64n32k8 in TF32
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[0:64] += A(registers, TF32) . B(desc, K-major), m64n128k8
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0:32] += A(registers, TF32) . B(desc, K-major), m64n64k8
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0:40] += A(registers, TF32) . B(desc, K-major), m64n80k8
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0:16] += A(registers, TF32) . B(desc, K-major), m64n32k8
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O += P.V for one k8 step: m64n{hd}k8 over V^T's real head dims
template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&d)[HD / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (HD == 128) wgmma_rs_n128(d, a, db);
  else if constexpr (HD == 80) wgmma_rs_n80(d, a, db);
  else if constexpr (HD == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n32(d, a, db);
}

// kLo: K and V carry a low part (f32 inputs); bf16 inputs have none
template <int HD, bool kLo>
__global__ void __launch_bounds__(kThreads, 1)
flash_partial_tf32(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   float* __restrict__ acc_out, float* __restrict__ m_out,
                   float* __restrict__ l_out, int B, int Sq, int Skv, int H,
                   int q_off, int k_off) {
  using L = Tiles<HD>;
  constexpr int kBoxes = L::kBoxes;
  extern __shared__ uint8_t fp_smem[];
  // barriers: q, K full x2, V full x2, stage empty x2
  __shared__ __align__(8) uint64_t bars[1 + 3 * kStages];
  const uint32_t sq = (smem_addr(fp_smem) + 1023) & ~1023u;  // swizzle atom
  const uint32_t skv = sq + 2 * L::kQ;   // stage s: K hi, K lo, V hi, V lo
  const uint32_t qbar = smem_addr(&bars[0]);
  const uint32_t kfull = qbar + 8, vfull = kfull + 8 * kStages,
                 empty = vfull + 8 * kStages;

  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int qt = gridDim.y - 1 - blockIdx.y;   // heaviest tiles first
  const int q0 = qt * kBQ;
  // every row of the tile sees key k_off when the first one does; then the
  // key tiles past the last row's causal limit contribute exactly 0
  int kv_end = Skv;
  if (q_off + q0 >= k_off)
    kv_end = min(Skv, q_off + min(Sq, q0 + kBQ) - k_off);
  const int ntiles = (kv_end + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(kfull + 8 * s, 1);
      mbar_init(vfull + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer: one thread issues every TMA load; the low planes are
    // batches B .. 2B - 1 of each map ----
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(qbar, 2 * L::kQ);
      for (int x = 0; x < kBoxes; ++x) {
        tma_load(sq + x * kBQ * 128, &tq, qbar, x * kCols, h, q0, b);
        tma_load(sq + L::kQ + x * kBQ * 128, &tq, qbar, x * kCols, h, q0, B + b);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kStages;
        const uint32_t khi = skv + s * L::kStage, klo = khi + L::kK,
                       vhi = klo + L::kK, vlo = vhi + L::kV;
        mbar_wait(empty + 8 * s, ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(kfull + 8 * s, (kLo ? 2 : 1) * L::kK);
        for (int x = 0; x < kBoxes; ++x) {
          tma_load(khi + x * kBK * 128, &tk, kfull + 8 * s, x * kCols, h, t * kBK, b);
          if (kLo)
            tma_load(klo + x * kBK * 128, &tk, kfull + 8 * s, x * kCols, h, t * kBK, B + b);
        }
        mbar_expect_tx(vfull + 8 * s, (kLo ? 2 : 1) * L::kV);
        tma_load(vhi, &tv, vfull + 8 * s, t * kBK, 0, h, b);
        if (kLo) tma_load(vlo, &tv, vfull + 8 * s, t * kBK, 0, h, B + b);
      }
    }
    return;
  }

  // ---- consumers: 64 query rows ----
  const int tid = threadIdx.x;
  // accumulator layout: this thread holds rows r and r + 8 (relative to the
  // shard), and in each 8-column block j the columns 8j + c and 8j + c + 1
  const int r = q0 + (tid / 32) * 16 + (tid % 32) / 4;
  const int c = (tid % 4) * 2;
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  mbar_wait(qbar, 0);

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % kStages;
    const uint32_t parity = (t / kStages) & 1;
    const uint32_t khi = skv + s * L::kStage, klo = khi + L::kK,
                   vhi = klo + L::kK, vlo = vhi + L::kV;

    // S = Qhi.Khi + Qlo.Khi (+ Qhi.Klo): hd / 8 steps of k8 each, over the
    // real columns only (hd = 80: 10 steps, the zero fill past them unread)
    float sc[kBK / 2];
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) sc[i] = 0.f;
    mbar_wait(kfull + 8 * s, parity);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      const uint32_t qo = (kk / 4) * kBQ * 128 + (kk % 4) * 32;
      const uint32_t ko = (kk / 4) * kBK * 128 + (kk % 4) * 32;
      const uint64_t dkh = kmajor_desc(khi + ko);
      wgmma_ss_n32(sc, kmajor_desc(sq + qo), dkh, kk);
      wgmma_ss_n32(sc, kmajor_desc(sq + L::kQ + qo), dkh, 1);
      if (kLo) wgmma_ss_n32(sc, kmajor_desc(sq + qo), kmajor_desc(klo + ko), 1);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(sc);

    // mask unless every key of the tile exists and every row sees it
    const int k0 = t * kBK;
    if (k0 + kBK > Skv || k_off + k0 + kBK - 1 > q_off + q0) {
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * j + c + (e & 1);
          const int qpos = q_off + r + 8 * (e >> 1);
          float& x = sc[4 * j + e];
          x = kp >= Skv ? -INFINITY : (k_off + kp <= qpos ? x : kNegInf);
        }
      }
    }

    // online softmax in f32
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = ex2((m[i] - m_new) * kLog2e);
      m[i] = m_new;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      const int row = (i >> 1) & 1;
      const float diff = sc[i] - m[row];
      sc[i] = ex2(diff * kLog2e);
      l[row] += sc[i];
    }
    // P = Phi + Plo as the A fragments of the four k8 steps: a0..a3 are
    // (row, k = t), (row + 8, k = t), (row, k = t + 4), (row + 8, k = t + 4)
    // and k = t, t + 4 are keys 2t, 2t + 1 in V^T's order
    uint32_t ph[kBK / 8][4], pl[kBK / 8][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float p = sc[4 * kk + ((a & 1) << 1) + (a >> 1)];
        const float hi = tf32(p);
        ph[kk][a] = __float_as_uint(hi);
        pl[kk][a] = __float_as_uint(tf32(p - hi));
      }
    }
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

    // O += Phi.Vhi + Plo.Vhi (+ Phi.Vlo): V^T's rows are hd (N), its
    // 128-byte rows the tile's 32 keys (K)
    mbar_wait(vfull + 8 * s, parity);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      const uint64_t dvh = kmajor_desc(vhi + kk * 32);
      wgmma_pv<HD>(acc, ph[kk], dvh);
      wgmma_pv<HD>(acc, pl[kk], dvh);
      if (kLo) wgmma_pv<HD>(acc, ph[kk], kmajor_desc(vlo + kk * 32));
    }
    wg_commit();
    wg_wait_all();
    fence_regs(acc);
    mbar_arrive(empty + 8 * s);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int row = r + 8 * i;
    if (row < Sq) {
      const long long at = (static_cast<long long>(b) * Sq + row) * H + h;
      float* dst = acc_out + at * HD + c;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
      if (c == 0) {
        m_out[at] = m[i];
        l_out[at] = li;
      }
    }
  }
}

template <typename T>
int split(const void* q, const void* k, const void* v, float* qs, float* ks,
          float* vt, int B, int Sq, int Skv, int H, int hd, float scale,
          cudaStream_t st) {
  const long long nq = static_cast<long long>(B) * Sq * H * hd;
  const long long nk = static_cast<long long>(B) * Skv * H * hd;
  auto blocks = [](long long n) {
    const long long want = (n + 255) / 256;
    return static_cast<unsigned>(want < 132 * 32 ? want : 132 * 32);
  };
  split_rows<T><<<blocks(nq), 256, 0, st>>>(static_cast<const T*>(q), qs, qs + nq, nq, scale);
  split_rows<T><<<blocks(nk), 256, 0, st>>>(static_cast<const T*>(k), ks, ks + nk, nk, 1.f);
  const int Skv8 = (Skv + 7) / 8 * 8;
  const dim3 grid((Skv8 + 31) / 32, (hd + 31) / 32, B * H);
  split_vt<T><<<grid, 256, 0, st>>>(static_cast<const T*>(v), vt, B, Skv, Skv8, H, hd);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, bool kLo>
int launch(int device, const void* qs, const void* ks, const void* vt,
           float* acc, float* m, float* l, int B, int Sq, int Skv, int H,
           int q_off, int k_off, cudaStream_t st) {
  if ((reinterpret_cast<uintptr_t>(qs) | reinterpret_cast<uintptr_t>(ks) |
       reinterpret_cast<uintptr_t>(vt)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);  // TMA needs 16 B
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const long long Skv8 = (Skv + 7) / 8 * 8;
  const auto f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, encode, f32, qs, {HD, H, Sq, 2LL * B}, {kCols, 1, kBQ, 1}) ||
      !make_map(&mk, encode, f32, ks, {HD, H, Skv, 2LL * B}, {kCols, 1, kBK, 1}) ||
      !make_map(&mv, encode, f32, vt, {Skv8, HD, H, 2LL * B}, {kBK, HD, 1, 1}))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool sized[64] = {};              // per device: dynamic smem raised
  if (device < 0 || device >= 64 || !sized[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_partial_tf32<HD, kLo>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Tiles<HD>::kDynamic);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device >= 0 && device < 64) sized[device] = true;
  }
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_partial_tf32<HD, kLo><<<grid, kThreads, Tiles<HD>::kDynamic, st>>>(
      mq, mk, mv, acc, m, l, B, Sq, Skv, H, q_off, k_off);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The split pass.  dtype: 0 = float32, 1 = bfloat16; hd a multiple of 16.
// qs: (2, B, Sq, H, hd), ks: (2, B, Skv, H, hd), vt: (2, B, H, hd, Skv8),
// all f32, Skv8 = Skv rounded up to 8; the wrapper has checked shapes and
// contiguity.
extern "C" int ishmem_flash_partial_split(int device, const void* q, const void* k,
                                          const void* v, void* qs, void* ks, void* vt,
                                          int B, int Sq, int Skv, int H, int hd,
                                          int dtype, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (hd % 16) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Sq == 0 || Skv == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float *fq = static_cast<float*>(qs), *fk = static_cast<float*>(ks), *fv = static_cast<float*>(vt);
  if (dtype == 0) return split<float>(q, k, v, fq, fk, fv, B, Sq, Skv, H, hd, scale, st);
  if (dtype == 1) return split<__nv_bfloat16>(q, k, v, fq, fk, fv, B, Sq, Skv, H, hd, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The partial over the split pass's planes.  hd must be 32, 64, 80 or 128;
// kv_lo
// is 1 when K and V have low parts (f32 inputs), 0 for bf16 inputs.
extern "C" int ishmem_flash_partial(int device, const void* qs, const void* ks,
                                    const void* vt, void* acc, void* m, void* l,
                                    int B, int Sq, int Skv, int H, int hd,
                                    int q_off, int k_off, int kv_lo, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || Sq == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float *a = static_cast<float*>(acc), *fm = static_cast<float*>(m), *fl = static_cast<float*>(l);
  if (hd == 128 && kv_lo)
    return launch<128, true>(device, qs, ks, vt, a, fm, fl, B, Sq, Skv, H, q_off, k_off, st);
  if (hd == 128)
    return launch<128, false>(device, qs, ks, vt, a, fm, fl, B, Sq, Skv, H, q_off, k_off, st);
  if (hd == 64 && kv_lo)
    return launch<64, true>(device, qs, ks, vt, a, fm, fl, B, Sq, Skv, H, q_off, k_off, st);
  if (hd == 64)
    return launch<64, false>(device, qs, ks, vt, a, fm, fl, B, Sq, Skv, H, q_off, k_off, st);
  if (hd == 80 && kv_lo)
    return launch<80, true>(device, qs, ks, vt, a, fm, fl, B, Sq, Skv, H, q_off, k_off, st);
  if (hd == 80)
    return launch<80, false>(device, qs, ks, vt, a, fm, fl, B, Sq, Skv, H, q_off, k_off, st);
  if (hd == 32 && kv_lo)
    return launch<32, true>(device, qs, ks, vt, a, fm, fl, B, Sq, Skv, H, q_off, k_off, st);
  if (hd == 32)
    return launch<32, false>(device, qs, ks, vt, a, fm, fl, B, Sq, Skv, H, q_off, k_off, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

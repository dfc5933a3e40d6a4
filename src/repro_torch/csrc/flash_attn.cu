// K2: causal flash attention, forward; K11: the same over a paged pool.
//
// Replaces repro/kernels/flash_attn.py::flash_attention (the Pallas kernel
// that keeps each score tile in VMEM) together with the GQA head repeat of
// repro/kernels/ops.py::flash_attention.  q: (B, S, H, hd); k, v:
// (B, S, Hkv, hd), H a multiple of Hkv; out: (B, S, H, hd) in q's type.
// GQA reads kv head h / (H / Hkv) instead of materialising the repeat.
// Both paths keep the online softmax (running max m, denominator l,
// accumulator acc) in f32 and write acc / max(l, 1e-30) rounded to q's
// type once.  Sums run in another order than on the TPU, so results agree
// to a tolerance, not bitwise.
//
// bf16 (the serving path's prefill; K11's body): a Hopper kernel on wgmma
// tensor cores fed by TMA.  Bound: at the main path's prefill shape
// (B = 1, S = 512, 32/8 heads of 128) the bytes of q, k, v and o (3.1 us
// at 3.35 TB/s) exceed the causal products (2.2 us at 989 TFLOP/s); from
// S of about 750 on, and at the long-prefill shape S = 4096 (0.139 ms), the
// products bound it.  Design:
//  - one CTA of three warpgroups per (q tile of 128 rows, head, batch);
//    warpgroups 0 and 1 each own 64 query rows and run wgmma, one thread
//    of warpgroup 2 issues every load (setmaxnreg moves the producer's
//    registers to the consumers: 24 against 240);
//  - q, k and v are read through one 4-D tensor map each over
//    (B, S, heads, hd), boxes of 64 columns (128 bytes, the 128-byte
//    swizzle atom) by 128 rows; hd = 128 takes two boxes per tile.  Rows
//    past S are TMA's zero fill, never the next batch's rows;
//  - hd = 80 (zamba2's shared attention) keeps the global width 80 in the
//    maps and the tile width of hd = 128 in shared memory: the second box
//    holds columns 64..79 and TMA's zero fill past them (the map's inner
//    extent is 80, so no byte of the next head is read).  Q.K^T runs
//    hd / 16 = 5 k16 steps, P.V runs at n128 over the zero-padded V tile
//    (its columns 80..127 accumulate zeros) and the epilogue writes the 80
//    real columns.  One 80-column row is 160 bytes, so every stride of
//    the maps stays on TMA's 16-byte grid;
//  - q is loaded once; K/V tiles of BK = 128 keys go through a ring of two
//    stages with mbarrier completion (K and V on separate barriers, so
//    Q.K^T starts while V lands), so the next tile's copy overlaps this
//    tile's math.  Shared memory: q 32 KB + 2 x (K + V) 64 KB at hd = 128
//    (three stages measured no faster);
//  - S = Q.K^T is wgmma m64n128k16 with both operands K-major in shared
//    memory (the (BK, hd) K tile already is).  The f32 scores are scaled by
//    hd^-0.5 * log2(e) inside one FFMA with the running max, and 2^x is one
//    MUFU op (ex2.approx): with exp2f's range handling the softmax, not the
//    tensor cores, set the pace, and the kernel was measurably slower;
//  - O += P.V takes P from registers: the S accumulator's layout is the A
//    fragment's, so P is the softmax output rounded to bf16 in place.  V's
//    (BK, hd) row-major tile is the MN-major B operand (the transpose bit
//    of 16-bit wgmma); no transposed copy is written;
//  - BQ = BK, so only the last (diagonal) key tile of a q tile is masked
//    and the key loop stops at the causal limit;
//  - q tiles launch heaviest first (blockIdx.y counts down from the
//    diagonal's far end), so causal imbalance leaves no tail;
//  - within a warpgroup, S, softmax and P.V run in turn; the two consumer
//    warpgroups interleave on the tensor cores.  Issuing the next tile's S
//    beside this tile's P.V, to hide the softmax, measured slower: ptxas
//    serialized its wgmma (C7515: the softmax writes registers inside the
//    pipeline stage) and, though SASS carries the setmaxnreg requests, kept
//    the consumers within the entry's 168 registers, so hd = 128 spilled.
// Determinism: no atomics and no split over keys; the tile schedule depends
// on S, hd and the head ratio only, so one run gives the bits of the next,
// and row b of a B-batch call gives the bits of the same inputs at B = 1.
// The barrier, TMA and descriptor helpers and the tensor-map encoding are
// shared with K10 (tma.cuh).
//
// K11 (repro/kernels/ishmem_device.py::fused_paged_attn, bf16): the same
// kernel body with another K/V source.  Its reference gathers every table
// block's whole payload (all layers of all leaves, 2.36 MB a block at
// qwen3-4b) and then attends over one layer's K and V (64 KB a block); here
// the producer thread reads that layer's K and V straight from the decode
// PE's pool row through the slot table, one TMA box of T rows per block,
// so the kernel moves the bytes of q, out and one layer's K/V, its bound.
// Before the first K/V load it spins (acquire loads, bounded) on the signal
// words that gate the blocks, so no block byte is read before its signal.
// Unmapped entries and blocks past the table read TMA's zero fill, and
// keys at or past the leaf's width are zeroed in shared memory, so the
// tiles are the bytes K2 sees after the gather, and the output is bitwise
// K2's on the gathered leaf.
//
// f32 (the oracle of ring attention and of the f32 tests, not the serving
// path): the first version's plain-FMA kernel, unchanged.  The reference's
// 2e-5 f32 tolerance rules out bf16 and TF32 tensor cores there.  q is
// scaled by hd^-0.5 in f32 before the dot, masked scores are -1e30; one CTA
// of 256 threads per (q tile of 64 rows, head, batch), four threads per
// query row holding a quarter of its head dimension each (interleaved, so
// shared-memory reads of a key row are conflict-free), key/value tiles of
// 32 rows staged in shared memory as f32, scores in registers, the ragged
// last q and kv tiles masked.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int kBQ = 64;      // query rows per CTA
constexpr int kBK = 32;      // keys per shared-memory tile
constexpr int kLanes = 4;    // threads per query row
constexpr int kThreads = kBQ * kLanes;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int H,
                 int Hkv, float scale) {
  constexpr int D = HD / kLanes;  // head dims held by one thread
  __shared__ float ks[kBK][HD];
  __shared__ float vs[kBK][HD];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int row = tid / kLanes, part = tid % kLanes;
  const int qpos = qt * kBQ + row;
  const bool valid = qpos < S;

  float qr[D], acc[D];
  const long long qbase = ((static_cast<long long>(b) * S + qpos) * H + h) * HD;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = valid ? to_f(q[qbase + d * kLanes + part]) * scale : 0.f;
    acc[d] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  const int kv_end = min(S, (qt + 1) * kBQ);  // causal limit of this q tile
  const int ntiles = (kv_end + kBK - 1) / kBK;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int j = i / HD, d = i % HD, kp = k0 + j;
      const long long off = ((static_cast<long long>(b) * S + kp) * Hkv + hk) * HD + d;
      ks[j][d] = kp < S ? to_f(k[off]) : 0.f;
      vs[j][d] = kp < S ? to_f(v[off]) : 0.f;
    }
    __syncthreads();

    float s[kBK];
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot += qr[d] * ks[j][d * kLanes + part];
      // the four lanes of a row sum their partial dots; every lane ends
      // with the same bits (IEEE addition commutes)
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      s[j] = (k0 + j <= qpos) ? dot : kNegInf;
      tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    l = l * corr + psum;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] += s[j] * vs[j][d * kLanes + part];
    }
    m = m_new;
  }
  if (!valid) return;
  const float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int d = 0; d < D; ++d) o[qbase + d * kLanes + part] = from_f<T>(acc[d] / denom);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int Hkv, float scale, cudaStream_t stream) {
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, Hkv, scale);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

namespace hop {

constexpr int kBQ = 128;          // query rows per CTA (two warpgroups of 64)
constexpr int kBK = 128;          // keys per tile; equal to kBQ (see above)
constexpr int kStages = 2;        // K/V ring depth
constexpr int kThreads = 384;     // warpgroups 0, 1 consume; 2 produces
constexpr int kConsumers = 256;   // arrivals that free a K/V stage
constexpr int kCols = 64;         // bf16 columns of one 128-byte swizzle row
constexpr int kHalf = kBK * 128;  // bytes of one 64-column box of a tile
constexpr float kLog2e = 1.4426950408889634f;

template <int HD> struct Layout {
  // TMA's global strides (hd, H * hd, S * H * hd elements) must be
  // multiples of 16 bytes
  static_assert(HD * 2 % 16 == 0, "a row of hd bf16 values is not 16-byte aligned");
  static constexpr int kBoxes = (HD + kCols - 1) / kCols;  // 64-column boxes
  static constexpr int kPad = kBoxes * kCols;              // tile width
  static constexpr int kQ = kBQ * kPad * 2;                // q tile bytes
  static constexpr int kKV = kBK * kPad * 2;               // one K or V tile
  static constexpr int kDynamic = kQ + kStages * 2 * kKV + 1024;  // + align
};

// V's MN-major descriptor: 8-key groups SBO = 1024 bytes apart, 64-column
// boxes LBO = `box` bytes apart (the K-major one is in tma.cuh)
__device__ __forceinline__ uint64_t mn_desc(uint32_t addr, uint32_t box) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(box >> 4) << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d[0:64] (+)= A(desc, K-major) . B(desc, K-major), m64n128k16
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[0:64] += A(registers, bf16 pairs) . B(desc, MN-major), m64n128k16
__device__ __forceinline__ void wgmma_rs_n128_mn(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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

// d[0:32] += A(registers, bf16 pairs) . B(desc, MN-major), m64n64k16
__device__ __forceinline__ void wgmma_rs_n64_mn(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// O += P.V for one k16 step over a tile of width W: m64n128 at hd = 128
// and 80, m64n64 at hd = 64
template <int W>
__device__ __forceinline__ void wgmma_pv(float (&d)[W / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (W == 128) wgmma_rs_n128_mn(d, a, db);
  else wgmma_rs_n64_mn(d, a, db);
}

// K11's K/V source: a decode PE's pool row read through a slot table.
// The K and V maps then run over one paged leaf, (hd, Hkv, reps * T rows,
// num_blocks) with a block stride of the payload's bytes, in boxes of T
// rows; batch b is slot b, and key tile t is blocks t * (kBK / T) onward
// of the slot's table.  Entries equal to num_blocks (unmapped) and blocks
// past nb are the map's zero fill.
struct PagedSrc {
  const int* table;         // (B, nb) block ids
  const long long* waits;   // n_waits pairs (signal word address, value)
  int n_waits, nb, T;
  int row0;                 // the layer's first row in the leaf: layer * T
  int num_blocks;
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.global.acquire.gpu.b32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

// Spin until every signal word reaches its value (acquire loads), then
// order those loads before the TMA reads of the blocks they guard.  A word
// that never arrives is a protocol fault: trap after 10 s.
__device__ __forceinline__ void wait_signals(const long long* waits, int n) {
  for (int i = 0; i < n; ++i) {
    const int* word = reinterpret_cast<const int*>(waits[2 * i]);
    const int want = static_cast<int>(waits[2 * i + 1]);
    uint64_t since = 0;
    while (ld_acquire(word) < want) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (since == 0) since = now;
      else if (now - since > 10000000000ull) __trap();
    }
  }
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

// Zero rows from..kBK-1 of a K or V tile of width W (every 64-column box)
// and make the stores visible to this warpgroup's wgmma.  Whole 128-byte rows map onto
// themselves under the swizzle.  Both consumer warpgroups zero the same
// rows with the same bytes, so neither waits for the other.
template <int W>
__device__ __forceinline__ void zero_rows(uint32_t tile, int from, int wg) {
  const int per_box = (kBK - from) * 8;           // 16-byte chunks
  for (int i = threadIdx.x % 128; i < per_box * (W / kCols); i += 128) {
    const uint32_t at = tile + (i / per_box) * kHalf + from * 128 +
                        (i % per_box) * 16;
    asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(at),
                 "r"(0) : "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// The body of K2's bf16 kernel (kPaged false, K/V from dense (B, S, Hkv,
// hd) maps) and of K11 (kPaged true, K/V through the slot table): only the
// producer's K/V loads differ, and K11's consumers zero the rows at or
// past S of its last key tile, which the pool may fill with anything and
// which K2's map reads as zeros.  With the same tiles in shared memory the
// consumers compute the same bits.
template <int HD, bool kPaged>
__device__ __forceinline__ void attend(const CUtensorMap& tq,
                                       const CUtensorMap& tk,
                                       const CUtensorMap& tv,
                                       __nv_bfloat16* __restrict__ o, int S,
                                       int H, int Hkv, float scale_log2,
                                       const PagedSrc& pg) {
  using L = Layout<HD>;
  constexpr int kBoxes = L::kBoxes;
  extern __shared__ uint8_t fa_smem[];
  // barriers: q, K full x2, V full x2, stage empty x2
  __shared__ __align__(8) uint64_t bars[1 + 3 * kStages];
  const uint32_t sq = (smem_addr(fa_smem) + 1023) & ~1023u;  // swizzle atom
  const uint32_t skv = sq + L::kQ;        // stage s: K at skv + 2s kKV, V after
  const uint32_t qbar = smem_addr(&bars[0]);
  const uint32_t kfull = qbar + 8, vfull = kfull + 8 * kStages,
                 empty = vfull + 8 * kStages;

  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int hk = h / (H / Hkv);
  const int qt = gridDim.y - 1 - blockIdx.y;   // heaviest tiles first
  const int q0 = qt * kBQ;
  const int ntiles = qt + 1;                   // up to the diagonal tile

  // K11: this CTA's table entries, copied by every thread into the shared
  // memory past the K/V stages; entries past nb read as unmapped
  int* tab = nullptr;
  if constexpr (kPaged) {
    tab = reinterpret_cast<int*>(fa_smem + (sq - smem_addr(fa_smem)) +
                                 L::kQ + 2 * kStages * L::kKV);
    const int n = ntiles * (kBK / pg.T);
    for (int i = threadIdx.x; i < n; i += kThreads)
      tab[i] = i < pg.nb ? pg.table[static_cast<long long>(b) * pg.nb + i]
                         : pg.num_blocks;
  }

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

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(qbar, L::kQ);
      for (int x = 0; x < kBoxes; ++x)
        tma_load(sq + x * kBQ * 128, &tq, qbar, x * kCols, h, q0, b);
      if constexpr (kPaged) wait_signals(pg.waits, pg.n_waits);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kStages;
        const uint32_t ks = skv + 2 * s * L::kKV, vs = ks + L::kKV;
        mbar_wait(empty + 8 * s, ((t / kStages) & 1) ^ 1);
        if constexpr (kPaged) {
          // one box of T rows per block: block j of the tile lands at row
          // j * T, a multiple of 8 rows, so on the 1 KB swizzle pattern
          // of one 128-row box
          const int per_tile = kBK / pg.T;
          mbar_expect_tx(kfull + 8 * s, L::kKV);
          for (int j = 0; j < per_tile; ++j) {
            const int blk = tab[t * per_tile + j];
            for (int x = 0; x < kBoxes; ++x)
              tma_load(ks + x * kHalf + j * pg.T * 128, &tk, kfull + 8 * s,
                       x * kCols, hk, pg.row0, blk);
          }
          mbar_expect_tx(vfull + 8 * s, L::kKV);
          for (int j = 0; j < per_tile; ++j) {
            const int blk = tab[t * per_tile + j];
            for (int x = 0; x < kBoxes; ++x)
              tma_load(vs + x * kHalf + j * pg.T * 128, &tv, vfull + 8 * s,
                       x * kCols, hk, pg.row0, blk);
          }
        } else {
          mbar_expect_tx(kfull + 8 * s, L::kKV);
          for (int x = 0; x < kBoxes; ++x)
            tma_load(ks + x * kHalf, &tk, kfull + 8 * s, x * kCols, hk,
                     t * kBK, b);
          mbar_expect_tx(vfull + 8 * s, L::kKV);
          for (int x = 0; x < kBoxes; ++x)
            tma_load(vs + x * kHalf, &tv, vfull + 8 * s, x * kCols, hk,
                     t * kBK, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    // accumulator layout: this thread holds rows r and r + 8, and in each
    // 8-column block j the columns 8j + c and 8j + c + 1
    const int r = q0 + wg * 64 + (tid / 32) * 16 + (tid % 32) / 4;
    const int c = (tid % 4) * 2;
    const uint32_t qa = sq + wg * 64 * 128;   // this warpgroup's q rows
    float acc[L::kPad / 2];   // hd = 80: columns 80..127 stay zero
#pragma unroll
    for (int i = 0; i < L::kPad / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    mbar_wait(qbar, 0);

    for (int t = 0; t < ntiles; ++t) {
      const int s = t % kStages;
      const uint32_t parity = (t / kStages) & 1;
      const uint32_t ks = skv + 2 * s * L::kKV, vs = ks + L::kKV;
      const int k0 = t * kBK;
      // K11: keys at or past S in a mapped block are the pool's bytes
      const bool ragged = kPaged && k0 + kBK > S;

      // S = Q.K^T: hd / 16 steps of k16, 32 bytes along each 128-byte row
      float sc[kBK / 2];
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) sc[i] = 0.f;
      mbar_wait(kfull + 8 * s, parity);
      if (ragged) zero_rows<L::kPad>(ks, S - k0, wg);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk / 4) * kHalf + (kk % 4) * 32;
        wgmma_ss_n128(sc, kmajor_desc(qa + off), kmajor_desc(ks + off), kk);
      }
      wg_commit();
      wg_wait_all();
      fence_regs(sc);

      // online softmax in f32, log2 units; only the diagonal tile masks
      const bool diag = t == ntiles - 1;
      float mx[2] = {-INFINITY, -INFINITY};
      if (diag) {
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + 8 * j + c + (e & 1) > r + 8 * (e >> 1))
              sc[4 * j + e] = -INFINITY;
        }
      }
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
      }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i] * scale_log2);
        corr[i] = ex2(m[i] - m_new);
        m[i] = m_new;
        l[i] *= corr[i];
      }
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], scale_log2, -m[e >> 1]));
          l[e >> 1] += sc[4 * j + e];
        }
      }
      // P as the A fragment of k16 step kk: keys 16kk .. 16kk + 15
      uint32_t pf[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        pf[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        pf[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pf[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pf[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
#pragma unroll
      for (int i = 0; i < L::kPad / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

      // O += P.V: V's rows are keys (K), its columns hd (N, MN-major)
      mbar_wait(vfull + 8 * s, parity);
      if (ragged) zero_rows<L::kPad>(vs, S - k0, wg);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_pv<L::kPad>(acc, pf[kk], mn_desc(vs + kk * 16 * 128, kHalf));
      wg_commit();
      wg_wait_all();
      fence_regs(acc);
      mbar_arrive(empty + 8 * s);
    }

    const long long row_stride = static_cast<long long>(H) * HD;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      const float denom = fmaxf(li, 1e-30f);
      const int row = r + 8 * i;
      if (row < S) {   // the hd real columns: 8-column blocks j < hd / 8
        __nv_bfloat16* dst = o + (static_cast<long long>(b) * S + row) *
                                     row_stride + h * HD + c;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j + 2 * i] / denom,
                                    acc[4 * j + 2 * i + 1] / denom);
      }
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, int S, int H, int Hkv,
                float scale_log2) {
  attend<HD, false>(tq, tk, tv, o, S, H, Hkv, scale_log2, PagedSrc{});
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
paged_flash_wgmma(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  __nv_bfloat16* __restrict__ o, int S, int H, int Hkv,
                  float scale_log2, const PagedSrc pg) {
  attend<HD, true>(tq, tk, tv, o, S, H, Hkv, scale_log2, pg);
}

template <int HD>
int launch(int device, const void* q, const void* k, const void* v, void* o,
           int B, int S, int H, int Hkv, float scale, cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);  // TMA needs 16 B
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap mq, mk, mv;
  const auto bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!make_map(&mq, encode, bf16, q, {HD, H, S, B}, {kCols, 1, kBK, 1}) ||
      !make_map(&mk, encode, bf16, k, {HD, Hkv, S, B}, {kCols, 1, kBK, 1}) ||
      !make_map(&mv, encode, bf16, v, {HD, Hkv, S, B}, {kCols, 1, kBK, 1}))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool sized[64] = {};              // per device: dynamic smem raised
  if (device < 0 || device >= 64 || !sized[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Layout<HD>::kDynamic);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device >= 0 && device < 64) sized[device] = true;
  }
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  flash_fwd_wgmma<HD><<<grid, kThreads, Layout<HD>::kDynamic, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), S, H, Hkv,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// K11.  k and v: the first block's K and V leaf (the pool row's base plus
// the leaf's offset); meta: n_waits (address, value) int64 pairs, then the
// (B, nb) int32 table.
template <int HD>
int launch_paged(int device, const void* q, const void* k, const void* v,
                 void* o, const void* meta, int n_waits, int B, int S, int H,
                 int Hkv, long long leaf_rows, long long num_blocks,
                 long long block_bytes, int nb, int T, int layer, float scale,
                 cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | static_cast<uintptr_t>(block_bytes)) &
      15)
    return static_cast<int>(cudaErrorMisalignedAddress);  // TMA needs 16 B
  if (T < 8 || T % 8 || kBK % T || num_blocks > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap mq, mk, mv;
  const auto bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!make_map(&mq, encode, bf16, q, {HD, H, S, B}, {kCols, 1, kBK, 1}) ||
      !make_map(&mk, encode, bf16, k, {HD, Hkv, leaf_rows, num_blocks},
                {kCols, 1, T, 1}, block_bytes) ||
      !make_map(&mv, encode, bf16, v, {HD, Hkv, leaf_rows, num_blocks},
                {kCols, 1, T, 1}, block_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (S + kBQ - 1) / kBQ;
  const int smem = Layout<HD>::kDynamic + (tiles * (kBK / T) * 4 + 15) / 16 * 16;
  static int sized[64] = {};         // per device: dynamic smem raised to
  if (device < 0 || device >= 64 || sized[device] < smem) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_flash_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device >= 0 && device < 64) sized[device] = smem;
  }
  const PagedSrc pg{
      static_cast<const int*>(meta) + 4 * n_waits,
      static_cast<const long long*>(meta), n_waits, nb, T, layer * T,
      static_cast<int>(num_blocks)};
  const dim3 grid(B * H, tiles);
  paged_flash_wgmma<HD><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), S, H, Hkv, scale * kLog2e,
      pg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hop

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  hd must be 64, 80 or 128; the wrapper
// has checked shapes, contiguity and that H is a multiple of Hkv.
extern "C" int ishmem_flash_attention(int device, const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int H, int Hkv, int hd, int dtype,
                                      float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 128)
    return launch<float, 128>(q, k, v, o, B, S, H, Hkv, scale, st);
  if (dtype == 0 && hd == 80)
    return launch<float, 80>(q, k, v, o, B, S, H, Hkv, scale, st);
  if (dtype == 0 && hd == 64)
    return launch<float, 64>(q, k, v, o, B, S, H, Hkv, scale, st);
  if (dtype == 1 && hd == 128)
    return hop::launch<128>(device, q, k, v, o, B, S, H, Hkv, scale, st);
  if (dtype == 1 && hd == 80)
    return hop::launch<80>(device, q, k, v, o, B, S, H, Hkv, scale, st);
  if (dtype == 1 && hd == 64)
    return hop::launch<64>(device, q, k, v, o, B, S, H, Hkv, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K11, bf16 only: causal GQA attention of q (B slots, S = the leaf's width,
// H, hd) against one layer of one paged K/V leaf, read through the slot
// table in `meta` after the signal words there reach their values.  The
// wrapper has checked shapes, the table's range and every alignment.
extern "C" int ishmem_fused_paged_attn(int device, const void* q,
                                       const void* k, const void* v, void* o,
                                       const void* meta, int n_waits, int B,
                                       int S, int H, int Hkv, int hd,
                                       long long leaf_rows,
                                       long long num_blocks,
                                       long long block_bytes, int nb,
                                       int block_tokens, int layer,
                                       float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 128)
    return hop::launch_paged<128>(device, q, k, v, o, meta, n_waits, B, S, H,
                                  Hkv, leaf_rows, num_blocks, block_bytes, nb,
                                  block_tokens, layer, scale, st);
  if (hd == 80)
    return hop::launch_paged<80>(device, q, k, v, o, meta, n_waits, B, S, H,
                                 Hkv, leaf_rows, num_blocks, block_bytes, nb,
                                 block_tokens, layer, scale, st);
  if (hd == 64)
    return hop::launch_paged<64>(device, q, k, v, o, meta, n_waits, B, S, H,
                                 Hkv, leaf_rows, num_blocks, block_bytes, nb,
                                 block_tokens, layer, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

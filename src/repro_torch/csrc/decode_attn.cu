// Decode attention over the gathered block payload or a dense cache.
//
// Replaces no pallas_call: the reference decodes in plain jnp
// (repro/models/attention.py::decode_attn over the one-hot-written dense
// cache).  It was added so the paged decode step attends where K3 put the
// cache (serve/paged_attn.py), with no dense leaf rebuilt, no whole-cache
// rewrite, no f32 copy of K and V and no stacked new cache.
//
// One query token a row attends over positions [0, n_b), n_b = min(pos_b
// + 1, W), W = nb * T.  K and V come as a view (B, nb, T, nkv, hd) with any
// batch, block, token and head strides (multiples of 8 elements) and a
// contiguous head dim: the block payload gathered by K3, or a dense cache
// (nb = 1, T = W).  With k_new / v_new the row's new K/V column is stored
// in place at position pos_b (nothing where pos_b >= W) and attended as
// loaded from k_new / v_new.  q is widened to f32 and scaled, K and V
// are widened to f32 exactly, scores, softmax and both sums are f32, and
// the output is rounded to bf16.  The q_per_kv query heads of a KV head
// share each K/V load (GQA).
//
// Bound: bytes, the live K/V rows (about 4 flops a byte, far below the 295
// where the tensor cores would bound).  So the products run as f32 FMA on
// the CUDA cores and the kernel spends its effort on the loads: one CTA
// takes one (row, KV head) pair and one fixed chunk of kChunk positions,
// flash-decoding style, so a bank of 8 rows and 8 KV heads still spreads
// over every SM; a CTA whose chunk lies past n_b exits.  The chunk's K and
// V rows land in shared memory as 16-byte vectors (row stride an odd
// number of vectors, so no bank conflicts), scores and the chunk's softmax
// partial (max, sum, P.V) are taken there, each 16-byte K or V load from
// shared memory feeding 8 FMAs, and a second kernel merges the partials of
// a (row, query head) in chunk order.  The chunking is fixed in positions
// and every sum runs in a fixed order, so a row's output depends on its
// own inputs only: run to run, across batch positions and bank sizes, and
// between the dense and the payload view, the output is bitwise the same.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 64;        // positions a CTA attends over (fixed)
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeadDim = 256;
constexpr int kMaxGroup = 16;
// positions a call may hold: the merge keeps a weight a chunk in 48 KB of
// shared memory
constexpr long long kMaxWidth = 48LL * 1024 / sizeof(float) * kChunk;
static_assert(kChunk == 64, "the softmax pass gives each lane two positions");

struct Geometry {
  int nkv, group, hd, T, W, chunks;
  long long sB, sN, sT, sH;       // K/V strides in elements
};

union Vec {
  uint4 u;
  unsigned short s[8];
};

__device__ __forceinline__ float widen(unsigned short x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}

__device__ __forceinline__ int live(const long long* pos, int b, int W) {
  const long long n = pos[b] + 1;
  return n < W ? static_cast<int>(n) : W;
}

// 16-byte vectors of a row in shared memory: odd, so the 8 threads of a
// quarter-warp that read 8 rows at one column hit 8 distinct bank groups
__host__ __device__ inline int row_vecs(int hd) { return (hd / 8) | 1; }

__host__ __device__ inline size_t smem_bytes(int hd, int group) {
  return 2 * static_cast<size_t>(kChunk) * row_vecs(hd) * sizeof(uint4) +
         static_cast<size_t>(group) * (hd + kChunk) * sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
decode_attn_chunk(const __nv_bfloat16* __restrict__ q,
                  __nv_bfloat16* __restrict__ k, __nv_bfloat16* __restrict__ v,
                  const __nv_bfloat16* __restrict__ k_new,
                  const __nv_bfloat16* __restrict__ v_new,
                  const long long* __restrict__ pos, float* __restrict__ acc,
                  float* __restrict__ ml, Geometry geo, float scale) {
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n = live(pos, b, geo.W);
  const int c0 = c * kChunk;
  if (c0 >= n) return;
  const int nr = min(kChunk, n - c0);
  const int hd = geo.hd, g = geo.group, vecs = hd / 8, rv = row_vecs(hd);
  extern __shared__ uint4 smem[];
  uint4* Ks = smem;
  uint4* Vs = Ks + kChunk * rv;
  float* qs = reinterpret_cast<float*>(Vs + kChunk * rv);     // (g, hd)
  float* S = qs + g * hd;                                      // (g, kChunk)
  const int t = threadIdx.x;

  const __nv_bfloat16* qh = q + (static_cast<long long>(b) * geo.nkv + h) * g * hd;
  for (int i = t; i < g * hd; i += kThreads)
    qs[i] = __bfloat162float(qh[i]) * scale;

  // the new column, where it lies in this chunk: its row comes from k_new
  // and v_new and is stored into the cache
  const long long p_new = pos[b];
  const int r_new = (k_new != nullptr && p_new >= c0 && p_new < c0 + nr)
                        ? static_cast<int>(p_new - c0) : -1;
  const long long kv_base = b * geo.sB + h * geo.sH;
#pragma unroll 4
  for (int i = t; i < nr * vecs; i += kThreads) {
    const int r = i / vecs, u = i - r * vecs;
    const int p = c0 + r;
    const long long at = kv_base + (p / geo.T) * geo.sN + (p % geo.T) * geo.sT + u * 8;
    uint4 kv, vv;
    if (r == r_new) {
      const long long o = (static_cast<long long>(b) * geo.nkv + h) * hd + u * 8;
      kv = *reinterpret_cast<const uint4*>(k_new + o);
      vv = *reinterpret_cast<const uint4*>(v_new + o);
    } else {
      kv = *reinterpret_cast<const uint4*>(k + at);
      vv = *reinterpret_cast<const uint4*>(v + at);
    }
    Ks[r * rv + u] = kv;
    Vs[r * rv + u] = vv;
  }
  if (r_new >= 0) {
    const int p = c0 + r_new;
    const long long at = kv_base + (p / geo.T) * geo.sN + (p % geo.T) * geo.sT;
    for (int u = t; u < vecs; u += kThreads) {
      const long long o = (static_cast<long long>(b) * geo.nkv + h) * hd + u * 8;
      *reinterpret_cast<uint4*>(k + at + u * 8) = *reinterpret_cast<const uint4*>(k_new + o);
      *reinterpret_cast<uint4*>(v + at + u * 8) = *reinterpret_cast<const uint4*>(v_new + o);
    }
  }
  __syncthreads();

  // scores: thread i takes (head i / kChunk, row i % kChunk), so a warp's
  // threads share a head (q read as a broadcast, 8 values in two loads)
  // and read 32 rows
  for (int i = t; i < g * kChunk; i += kThreads) {
    const int hq = i / kChunk, r = i - hq * kChunk;
    float s = -INFINITY;
    if (r < nr) {
      s = 0.f;
      const float4* qr = reinterpret_cast<const float4*>(qs + hq * hd);
      for (int u = 0; u < vecs; ++u) {
        Vec w;
        w.u = Ks[r * rv + u];
        const float4 a = qr[2 * u], z = qr[2 * u + 1];
        const float qv[8] = {a.x, a.y, a.z, a.w, z.x, z.y, z.z, z.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) s = fmaf(qv[j], widen(w.s[j]), s);
      }
    }
    S[i] = s;
  }
  __syncthreads();

  // the chunk's softmax partial of each head: warp w takes heads w, w + 4..
  const int warp = t / 32, lane = t % 32;
  const long long pair = static_cast<long long>(b) * geo.nkv + h;
  for (int hq = warp; hq < g; hq += kWarps) {
    float* Sh = S + hq * kChunk;
    const float s0 = Sh[lane], s1 = Sh[lane + 32];
    float m = fmaxf(s0, s1);
    for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float p0 = lane < nr ? expf(s0 - m) : 0.f;
    const float p1 = lane + 32 < nr ? expf(s1 - m) : 0.f;
    Sh[lane] = p0;
    Sh[lane + 32] = p1;
    float l = p0 + p1;
    for (int o = 16; o; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) {
      float* out = ml + ((pair * geo.chunks + c) * g + hq) * 2;
      out[0] = m;
      out[1] = l;
    }
  }
  __syncthreads();

  // P.V: thread i takes head i / vecs and the 8 columns of vector i % vecs,
  // one 16-byte V load a row feeding 8 sums, rows in order
  for (int i = t; i < g * vecs; i += kThreads) {
    const int hq = i / vecs, u = i - hq * vecs;
    const float* P = S + hq * kChunk;
    float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < nr; ++r) {
      Vec w;
      w.u = Vs[r * rv + u];
      const float p = P[r];
#pragma unroll
      for (int j = 0; j < 8; ++j) a[j] = fmaf(p, widen(w.s[j]), a[j]);
    }
    float4* o = reinterpret_cast<float4*>(
        acc + ((pair * geo.chunks + c) * g + hq) * hd + u * 8);
    o[0] = make_float4(a[0], a[1], a[2], a[3]);
    o[1] = make_float4(a[4], a[5], a[6], a[7]);
  }
}

// one CTA a (row, KV head, query head): the chunks' partials merged in
// chunk order.  One warp takes the chunk weights exp(m_c - M) and the sum
// L, every thread then one column's weighted sum of the chunks' P.V
__global__ void __launch_bounds__(kThreads)
decode_attn_merge(const float* __restrict__ acc, const float* __restrict__ ml,
                  const long long* __restrict__ pos, __nv_bfloat16* __restrict__ out,
                  Geometry geo) {
  const int hq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int chunks = (live(pos, b, geo.W) + kChunk - 1) / kChunk;
  const int g = geo.group, hd = geo.hd, t = threadIdx.x;
  const long long pair = static_cast<long long>(b) * geo.nkv + h;
  const float* mlp = ml + pair * geo.chunks * g * 2;
  const float* ap = acc + pair * geo.chunks * g * hd;
  extern __shared__ float weight[];             // (chunks,)
  __shared__ float total;
  if (t < 32) {
    float M = -INFINITY;
    for (int c = t; c < chunks; c += 32) M = fmaxf(M, mlp[(c * g + hq) * 2]);
    for (int o = 16; o; o >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    float L = 0.f;
    for (int c = t; c < chunks; c += 32) {
      const float e = expf(mlp[(c * g + hq) * 2] - M);
      weight[c] = e;
      L = fmaf(mlp[(c * g + hq) * 2 + 1], e, L);
    }
    for (int o = 16; o; o >>= 1) L += __shfl_xor_sync(0xffffffffu, L, o);
    if (t == 0) total = L;
  }
  __syncthreads();
  for (int d = t; d < hd; d += kThreads) {
    float O = 0.f;
#pragma unroll 4
    for (int c = 0; c < chunks; ++c)
      O = fmaf(ap[(static_cast<long long>(c) * g + hq) * hd + d], weight[c], O);
    out[(pair * g + hq) * hd + d] = __float2bfloat16(O / total);
  }
}

}  // namespace

// q (B, 1, nkv * group, hd) and out contiguous bf16; k, v bf16 views
// (B, nb, T, nkv, hd) with the strides given (elements), 16-byte aligned;
// k_new, v_new (B, 1, nkv, hd) contiguous bf16 or both null; pos (B,)
// int64; acc (B, nkv, chunks, group, hd) and ml (B, nkv, chunks, group, 2)
// f32 scratch, chunks = ceil(nb * T / 64).  The wrapper has checked every
// shape, stride and alignment, hd a multiple of 8 up to 256 and group at
// most 16.
extern "C" int ishmem_decode_attention(
    int device, const void* q, void* k, void* v, const void* k_new,
    const void* v_new, const void* pos, void* acc, void* ml, void* out, int B,
    int nb, int T, int nkv, int group, int hd, long long sB, long long sN,
    long long sT, long long sH, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (hd % 8 || hd > kMaxHeadDim || group < 1 || group > kMaxGroup ||
      nb * static_cast<long long>(T) > kMaxWidth)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || nkv == 0 || nb * T == 0) return 0;
  Geometry geo{nkv, group, hd, T, nb * T, (nb * T + kChunk - 1) / kChunk,
               sB, sN, sT, sH};
  const size_t smem = smem_bytes(hd, group);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(decode_attn_chunk,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  decode_attn_chunk<<<dim3(geo.chunks, nkv, B), kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(k),
      static_cast<__nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(k_new),
      static_cast<const __nv_bfloat16*>(v_new),
      static_cast<const long long*>(pos), static_cast<float*>(acc),
      static_cast<float*>(ml), geo, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_attn_merge<<<dim3(group, nkv, B), kThreads, geo.chunks * sizeof(float), st>>>(
      static_cast<const float*>(acc), static_cast<const float*>(ml),
      static_cast<const long long*>(pos), static_cast<__nv_bfloat16*>(out), geo);
  return static_cast<int>(cudaGetLastError());
}

// K10: one ring step's partial causal attention, unnormalised.
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
// hd = 128) the causal QK^T and PV products dominate the bytes.  This
// first version, like K2 (csrc/flash_attn.cu), runs on plain f32 FMA: one
// CTA of 256 threads per (q tile of 64 rows, head, batch), four threads
// per query row, key/value tiles of 32 rows staged in shared memory as f32,
// scores in registers.  A tile whose first query already sees the shard's
// first key stops at its last query's causal limit: the key tiles after it
// would add exactly 0 to rows that hold a real running max.  Any other
// tile walks every key tile, so rows that see no key get the reference's
// fully-masked values.  wgmma and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;      // query rows per CTA
constexpr int kBK = 32;      // keys per shared-memory tile
constexpr int kLanes = 4;    // threads per query row
constexpr int kThreads = kBQ * kLanes;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, float* __restrict__ acc_out,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     int Sq, int Skv, int H, int q_off, int k_off,
                     float scale) {
  constexpr int D = HD / kLanes;  // head dims held by one thread
  __shared__ float ks[kBK][HD];
  __shared__ float vs[kBK][HD];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int row = tid / kLanes, part = tid % kLanes;
  const int qrel = qt * kBQ + row;
  const bool valid = qrel < Sq;
  const int qpos = q_off + qrel;  // absolute

  float qr[D], acc[D];
  const long long qrow = (static_cast<long long>(b) * Sq + qrel) * H + h;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = valid ? to_f(q[qrow * HD + d * kLanes + part]) * scale : 0.f;
    acc[d] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  // every row of the tile sees key k_off when the first one does; then the
  // key tiles past the last row's causal limit contribute exactly 0
  int kv_end = Skv;
  const int q_first = q_off + qt * kBQ;
  if (q_first >= k_off) {
    const int q_last = q_off + min(Sq, (qt + 1) * kBQ) - 1;
    kv_end = min(Skv, q_last - k_off + 1);
  }
  const int ntiles = (kv_end + kBK - 1) / kBK;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int j = i / HD, d = i % HD, kp = k0 + j;
      const long long off = ((static_cast<long long>(b) * Skv + kp) * H + h) * HD + d;
      ks[j][d] = kp < Skv ? to_f(k[off]) : 0.f;
      vs[j][d] = kp < Skv ? to_f(v[off]) : 0.f;
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
      const int kp = k0 + j;
      s[j] = kp >= Skv ? -INFINITY : (k_off + kp <= qpos ? dot : kNegInf);
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
#pragma unroll
  for (int d = 0; d < D; ++d) acc_out[qrow * HD + d * kLanes + part] = acc[d];
  if (part == 0) {
    m_out[qrow] = m;
    l_out[qrow] = l;
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* acc, void* m,
           void* l, int B, int Sq, int Skv, int H, int q_off, int k_off,
           float scale, cudaStream_t stream) {
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_partial_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<float*>(acc), static_cast<float*>(m), static_cast<float*>(l),
      Sq, Skv, H, q_off, k_off, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  hd must be 64 or 128; the wrapper has
// checked shapes (k and v (B, Skv, H, hd)) and contiguity.
extern "C" int ishmem_flash_partial(int device, const void* q, const void* k,
                                    const void* v, void* acc, void* m, void* l,
                                    int B, int Sq, int Skv, int H, int hd,
                                    int q_off, int k_off, int dtype,
                                    float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || Sq == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 128)
    return launch<float, 128>(q, k, v, acc, m, l, B, Sq, Skv, H, q_off, k_off, scale, st);
  if (dtype == 0 && hd == 64)
    return launch<float, 64>(q, k, v, acc, m, l, B, Sq, Skv, H, q_off, k_off, scale, st);
  if (dtype == 1 && hd == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, acc, m, l, B, Sq, Skv, H, q_off, k_off, scale, st);
  if (dtype == 1 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, acc, m, l, B, Sq, Skv, H, q_off, k_off, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

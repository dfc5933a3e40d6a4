// K2: causal flash attention, forward.
//
// Replaces repro/kernels/flash_attn.py::flash_attention (the Pallas kernel
// that keeps each score tile in VMEM) together with the GQA head repeat of
// repro/kernels/ops.py::flash_attention.  q: (B, S, H, hd); k, v:
// (B, S, Hkv, hd), H a multiple of Hkv; out: (B, S, H, hd) in q's type.
//
// Arithmetic follows the reference step for step: q is scaled by hd^-0.5
// in f32 before the dot, scores of keys after the query are -1e30, the
// softmax is online in f32 (running max m, denominator l, accumulator acc),
// and the output is acc / max(l, 1e-30) rounded to q's type.  Sums run in
// another order than on the TPU, so results agree to a tolerance, not
// bitwise.
//
// Bound: at the main path's shapes (S = 512, hd = 128) the bytes of q, k,
// v and o set the floor, not the tensor-core rate.  This first version does
// not reach either: it uses plain FMA, one CTA of 256 threads per
// (q tile of 64 rows, head, batch), four threads per query row holding a
// quarter of its head dimension each (interleaved, so shared-memory reads
// of a key row are conflict-free), and key/value tiles of 32 rows staged
// in shared memory as f32.  Scores never leave registers.  GQA reads kv
// head h / (H / Hkv) instead of materialising the repeat, and the ragged
// last q and kv tiles are masked instead of shrinking the blocks.
// wgmma, TMA and a pipelined producer are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;      // query rows per CTA
constexpr int kBK = 32;      // keys per shared-memory tile
constexpr int kLanes = 4;    // threads per query row
constexpr int kThreads = kBQ * kLanes;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  hd must be 64 or 128; the wrapper has
// checked shapes, contiguity and that H is a multiple of Hkv.
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
  if (dtype == 0 && hd == 64)
    return launch<float, 64>(q, k, v, o, B, S, H, Hkv, scale, st);
  if (dtype == 1 && hd == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, B, S, H, Hkv, scale, st);
  if (dtype == 1 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, B, S, H, Hkv, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

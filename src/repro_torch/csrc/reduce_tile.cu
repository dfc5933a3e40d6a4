// K9: the vectorised tile reduction.
//
// Replaces repro/kernels/reduce_tile.py::reduce_tile (the Pallas kernel
// _reduce_kernel, the compute body of the engine-path reduce): rows
// (T, N) -> out (N,) by sum, max, min or prod over the T rows.  As in the
// TPU kernel, every input type (f32, bf16, int32) is widened to f32, the
// rows fold in order 0, 1, ..., T-1 in f32, and the result is cast back to
// the input type (bf16 round to nearest even, int32 truncation toward
// zero), so int32 sums are exact below 2^24 only, as on the TPU.
//
// Bound: bytes.  The function reads T*N and writes N elements.  The
// paper's address split is the grid here: one thread per 16-byte vector of
// columns (4 f32/int32 or 8 bf16 values), one 16-byte load per row, so a
// warp reads 512 contiguous bytes per row and the fold of each column runs
// in registers.  Each column folds in the same order as the plain version
// with correctly rounded single operations (__fadd_rn, __fmul_rn: no
// contraction), so the result equals it bitwise.  A base pointer that is
// not 16-byte aligned takes the same kernel one element per thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// element types by their storage: conversion to and from the f32 fold
struct F32 {
  using S = float;
  __device__ static float to(S x) { return x; }
  __device__ static S from(float x) { return x; }
};
struct BF16 {
  using S = unsigned short;
  __device__ static float to(S x) { return __uint_as_float(static_cast<unsigned>(x) << 16); }
  __device__ static S from(float x) { return __bfloat16_as_ushort(__float2bfloat16(x)); }
};
struct I32 {
  using S = int;
  __device__ static float to(S x) { return static_cast<float>(x); }
  __device__ static S from(float x) { return static_cast<int>(x); }
};

// 0 sum, 1 max, 2 min, 3 prod; max and min propagate NaN like torch's
template <int OP>
__device__ __forceinline__ float fold(float a, float b) {
  if (OP == 0) return __fadd_rn(a, b);
  if (OP == 3) return __fmul_rn(a, b);
  if (isnan(a) || isnan(b)) return __fadd_rn(a, b);
  if (OP == 1) return a > b ? a : b;
  return a < b ? a : b;
}

// V elements per thread, moved as one unit U of V * sizeof(S) bytes
template <typename E, typename U>
union Pack {
  U u;
  typename E::S s[sizeof(U) / sizeof(typename E::S)];
};

template <typename E, typename U, int OP>
__global__ void __launch_bounds__(kThreads)
reduce_tile_kernel(const U* __restrict__ rows, U* __restrict__ out, int T_rows,
                   long long units) {
  constexpr int V = sizeof(U) / sizeof(typename E::S);
  const long long g = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (g >= units) return;
  Pack<E, U> p;
  p.u = rows[g];
  float acc[V];
#pragma unroll
  for (int c = 0; c < V; ++c) acc[c] = E::to(p.s[c]);
  for (int i = 1; i < T_rows; ++i) {
    p.u = rows[static_cast<long long>(i) * units + g];
#pragma unroll
    for (int c = 0; c < V; ++c) acc[c] = fold<OP>(acc[c], E::to(p.s[c]));
  }
#pragma unroll
  for (int c = 0; c < V; ++c) p.s[c] = E::from(acc[c]);
  out[g] = p.u;
}

template <typename E, typename U, int OP>
int launch(const void* rows, void* out, int T_rows, long long N, cudaStream_t st) {
  const long long units = N * static_cast<long long>(sizeof(typename E::S)) / sizeof(U);
  const long long blocks = (units + kThreads - 1) / kThreads;
  reduce_tile_kernel<E, U, OP><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const U*>(rows), static_cast<U*>(out), T_rows, units);
  return static_cast<int>(cudaGetLastError());
}

template <typename E, typename U>
int by_op(int op, const void* rows, void* out, int T_rows, long long N, cudaStream_t st) {
  switch (op) {
    case 0: return launch<E, U, 0>(rows, out, T_rows, N, st);
    case 1: return launch<E, U, 1>(rows, out, T_rows, N, st);
    case 2: return launch<E, U, 2>(rows, out, T_rows, N, st);
    case 3: return launch<E, U, 3>(rows, out, T_rows, N, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename E>
int by_align(int op, const void* rows, void* out, int T_rows, long long N, cudaStream_t st) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(rows) | reinterpret_cast<uintptr_t>(out);
  if (bases % 16 == 0) return by_op<E, uint4>(op, rows, out, T_rows, N, st);
  return by_op<E, typename E::S>(op, rows, out, T_rows, N, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = int32; op: 0 sum, 1 max, 2 min,
// 3 prod.  The wrapper has checked that rows is a contiguous (T, N) array
// with T >= 1 and N a multiple of 128 (so 16-byte units tile every row).
extern "C" int ishmem_reduce_tile(int device, const void* rows, void* out,
                                  int T_rows, long long N, int dtype, int op,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_align<F32>(op, rows, out, T_rows, N, st);
  if (dtype == 1) return by_align<BF16>(op, rows, out, T_rows, N, st);
  if (dtype == 2) return by_align<I32>(op, rows, out, T_rows, N, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

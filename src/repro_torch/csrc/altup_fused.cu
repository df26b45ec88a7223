// Fused AltUp predict + correct (paper Alg. 1, steps 1 and 3) for Hopper.
//
// Replaces the TPU kernel repro/kernels/altup_fused.py::altup_predict_correct
// (Pallas body `_kernel`). For every token t and feature c:
//
//   xhat_i = sum_j p[i, j] * x_wide[t, j, c]
//   out[t, i, c] = xhat_i + g[i] * (x_tilde[t, c] - sum_k sel[k] * xhat_k)
//
// computed in f32 and stored in the dtype of x_wide (float32 or bf16).
//
// What bounds it on the H100: bytes. It does ~2K^2 + 3K flops per element
// against (2K + 1) elements moved per feature of a token, far below the
// ~295 flop/byte ridge, so the least time is (2K+1)*T*d*bytes / 3.35 TB/s.
// At the decode shape of the served model (T = 8 slots, K = 2, d = 1024,
// bf16) that is 80 KB, well under a microsecond: the kernel is bound by
// its launch, not by the card.
//
// Design: one pass, nothing staged through shared memory but the K*K + 2K
// scalars. Each thread owns one 16-byte vector of features of one token
// (4 floats or 8 bf16), loads the K stream vectors and the x_tilde vector
// once, and writes the K outputs once, so device memory sees exactly the
// bytes of the bound. A d that is not a multiple of the vector width, or
// an unaligned pointer, takes the one-element-per-thread instantiation.
// K is a runtime argument with a static bound of 8 (asserted by the
// wrapper), so the K loops unroll into registers.

#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kMaxK = 8;
constexpr int kThreads = 256;

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    altup_predict_correct_kernel(const T* __restrict__ x_wide,
                                 const T* __restrict__ x_tilde,
                                 const float* __restrict__ p,
                                 const float* __restrict__ g,
                                 const float* __restrict__ sel,
                                 T* __restrict__ out, long long n_tok, int K,
                                 int d) {
  __shared__ float sp[kMaxK * kMaxK];
  __shared__ float sg[kMaxK];
  __shared__ float ss[kMaxK];
  for (int i = threadIdx.x; i < K * K; i += blockDim.x) sp[i] = p[i];
  if (threadIdx.x < K) {
    sg[threadIdx.x] = g[threadIdx.x];
    ss[threadIdx.x] = sel[threadIdx.x];
  }
  __syncthreads();

  const int nvec = d / VEC;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_tok * nvec) return;
  const long long t = idx / nvec;
  const int c = (int)(idx - t * nvec) * VEC;

  using P = Pack<T, VEC>;
  P xw[kMaxK];
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    if (j < K) xw[j] = *reinterpret_cast<const P*>(x_wide + (t * K + j) * d + c);
  }
  const P xt = *reinterpret_cast<const P*>(x_tilde + t * d + c);

  P o[kMaxK];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    float xhat[kMaxK];
    float xsel = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxK; ++i) {
      if (i < K) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < kMaxK; ++j) {
          if (j < K) acc += sp[i * K + j] * to_f32(xw[j].v[e]);
        }
        xhat[i] = acc;
        xsel += ss[i] * acc;
      }
    }
    const float delta = to_f32(xt.v[e]) - xsel;
#pragma unroll
    for (int i = 0; i < kMaxK; ++i) {
      if (i < K) o[i].v[e] = from_f32<T>(xhat[i] + sg[i] * delta);
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxK; ++i) {
    if (i < K) *reinterpret_cast<P*>(out + (t * K + i) * d + c) = o[i];
  }
}

template <typename T, int VEC>
void launch(const void* x_wide, const void* x_tilde, const void* p,
            const void* g, const void* sel, void* out, long long n_tok, int K,
            int d, cudaStream_t stream) {
  const long long n = n_tok * (d / VEC);
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  altup_predict_correct_kernel<T, VEC><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x_wide), static_cast<const T*>(x_tilde),
      static_cast<const float*>(p), static_cast<const float*>(g),
      static_cast<const float*>(sel), static_cast<T*>(out), n_tok, K, d);
}

}  // namespace
}  // namespace repro_torch

// x_wide (n_tok, K, d) and x_tilde (n_tok, d) contiguous in `dtype`;
// p (K, K), g (K,), sel (K,) contiguous float32; out like x_wide.
// vec is 1, or the 16-byte width (4 for float32, 8 for bf16) when d is a
// multiple of it and every pointer is 16-byte aligned. Returns the CUDA
// error code of the launch (0 = success).
extern "C" int altup_predict_correct_launch(const void* x_wide,
                                            const void* x_tilde,
                                            const void* p, const void* g,
                                            const void* sel, void* out,
                                            long long n_tok, int K, int d,
                                            int dtype, int vec,
                                            void* stream) {
  using namespace repro_torch;
  if (K < 1 || K > kMaxK || d < 1 || n_tok < 0 || d % vec != 0)
    return (int)cudaErrorInvalidValue;
  if (n_tok == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32 && vec == 4) {
    launch<float, 4>(x_wide, x_tilde, p, g, sel, out, n_tok, K, d, s);
  } else if (dtype == kFloat32 && vec == 1) {
    launch<float, 1>(x_wide, x_tilde, p, g, sel, out, n_tok, K, d, s);
  } else if (dtype == kBFloat16 && vec == 8) {
    launch<__nv_bfloat16, 8>(x_wide, x_tilde, p, g, sel, out, n_tok, K, d, s);
  } else if (dtype == kBFloat16 && vec == 1) {
    launch<__nv_bfloat16, 1>(x_wide, x_tilde, p, g, sel, out, n_tok, K, d, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

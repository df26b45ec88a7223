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
// What bounds it on the H100. Its bytes bound is (2K+1)*T*d elements over
// 3.35 TB/s (~2K^2 + 3K flops per element moved is far below the ridge).
// At the decode shape of the served model (T = 8 slots, K = 2, d = 1024,
// bf16) that is 80 KB, 0.025 us: far below the fixed cost of any kernel,
// so what the card spends there is the kernel's latency, the chain of
// dependent steps from its first instruction to its last store. At a
// prefill chunk (T = 512) the bytes bound is 1.6 us and the kernel should
// stream.
//
// Design, for the latency first:
//
// - One memory round trip. Each thread loads the K*K + 2K scalars straight
//   from global memory (every lane of a warp reads the same address: one
//   broadcast transaction, then L1 hits), in the same burst as its stream
//   loads, and nothing waits for them before the stream loads issue: no
//   shared-memory staging and no block barrier.
// - Many SMs. Blocks of 64 threads on a 2-D grid, x over the 16-byte
//   vectors of a token's features and y over tokens, so the decode shape
//   spreads over 16 blocks (16 SMs issue its loads) and a prefill chunk
//   over T * d / 512 blocks; every thread keeps K + 1 16-byte loads in
//   flight, and its K stores are 16 bytes each.
// - 32-bit index math. The grid gives the token and the vector directly,
//   without a division; a token's rows start at one 64-bit pointer, and
//   offsets inside it are 32-bit.
// - K is a runtime argument up to a compile-time bound KMAX (2, 4 or 8,
//   the smallest that holds K), so the K loops unroll into registers and
//   K = 2 holds no registers for blocks it does not have.
//
// Each thread reads its K stream vectors and x_tilde vector once and writes
// its K outputs once, so device memory sees exactly the bytes of the bound.
// A d that is not a multiple of the vector width, or an unaligned pointer,
// takes the one-element-per-thread instantiation.

#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kMaxK = 8;
constexpr int kThreads = 64;
constexpr int kMaxGridY = 65535;

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC, int KMAX>
__global__ void __launch_bounds__(kThreads)
    altup_predict_correct_kernel(const T* __restrict__ x_wide,
                                 const T* __restrict__ x_tilde,
                                 const float* __restrict__ p,
                                 const float* __restrict__ g,
                                 const float* __restrict__ sel,
                                 T* __restrict__ out, int n_tok, int K,
                                 int d) {
  using P = Pack<T, VEC>;
  const int c = (blockIdx.x * kThreads + threadIdx.x) * VEC;
  if (c >= d) return;
  // the scalars: broadcast loads, no staging, no barrier
  float pr[KMAX][KMAX], gr[KMAX], sr[KMAX];
#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    if (i < K) {
      gr[i] = __ldg(g + i);
      sr[i] = __ldg(sel + i);
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        if (j < K) pr[i][j] = __ldg(p + i * K + j);
      }
    }
  }
  const int row = K * d;
  for (int t = blockIdx.y; t < n_tok; t += gridDim.y) {
    const T* xw_t = x_wide + (size_t)t * row;
    T* out_t = out + (size_t)t * row;
    P xw[KMAX];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < K) xw[j] = *reinterpret_cast<const P*>(xw_t + j * d + c);
    }
    const P xt = *reinterpret_cast<const P*>(x_tilde + (size_t)t * d + c);

    P o[KMAX];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float xhat[KMAX];
      float xsel = 0.f;
#pragma unroll
      for (int i = 0; i < KMAX; ++i) {
        if (i < K) {
          float acc = 0.f;
#pragma unroll
          for (int j = 0; j < KMAX; ++j) {
            if (j < K) acc += pr[i][j] * to_f32(xw[j].v[e]);
          }
          xhat[i] = acc;
          xsel += sr[i] * acc;
        }
      }
      const float delta = to_f32(xt.v[e]) - xsel;
#pragma unroll
      for (int i = 0; i < KMAX; ++i) {
        if (i < K) o[i].v[e] = from_f32<T>(xhat[i] + gr[i] * delta);
      }
    }
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      if (i < K) *reinterpret_cast<P*>(out_t + i * d + c) = o[i];
    }
  }
}

template <typename T, int VEC, int KMAX>
void launch(const void* x_wide, const void* x_tilde, const void* p,
            const void* g, const void* sel, void* out, int n_tok, int K,
            int d, cudaStream_t stream) {
  const int nvec = d / VEC;
  const dim3 grid((nvec + kThreads - 1) / kThreads,
                  n_tok < kMaxGridY ? n_tok : kMaxGridY);
  altup_predict_correct_kernel<T, VEC, KMAX><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x_wide), static_cast<const T*>(x_tilde),
      static_cast<const float*>(p), static_cast<const float*>(g),
      static_cast<const float*>(sel), static_cast<T*>(out), n_tok, K, d);
}

template <typename T, int VEC>
void launch_k(const void* x_wide, const void* x_tilde, const void* p,
              const void* g, const void* sel, void* out, int n_tok, int K,
              int d, cudaStream_t s) {
  if (K <= 2) {
    launch<T, VEC, 2>(x_wide, x_tilde, p, g, sel, out, n_tok, K, d, s);
  } else if (K <= 4) {
    launch<T, VEC, 4>(x_wide, x_tilde, p, g, sel, out, n_tok, K, d, s);
  } else {
    launch<T, VEC, kMaxK>(x_wide, x_tilde, p, g, sel, out, n_tok, K, d, s);
  }
}

}  // namespace
}  // namespace repro_torch

// x_wide (n_tok, K, d) and x_tilde (n_tok, d) contiguous in `dtype`;
// p (K, K), g (K,), sel (K,) contiguous float32; out like x_wide.
// vec is 1, or the 16-byte width (4 for float32, 8 for bf16) when d is a
// multiple of it and every pointer is 16-byte aligned. n_tok and K * d
// must fit a 32-bit int. Returns the CUDA error code of the launch (0 =
// success).
extern "C" int altup_predict_correct_launch(const void* x_wide,
                                            const void* x_tilde,
                                            const void* p, const void* g,
                                            const void* sel, void* out,
                                            long long n_tok, int K, int d,
                                            int dtype, int vec,
                                            void* stream) {
  using namespace repro_torch;
  if (K < 1 || K > kMaxK || d < 1 || n_tok < 0 || n_tok > INT32_MAX ||
      (long long)K * d > INT32_MAX || d % vec != 0)
    return (int)cudaErrorInvalidValue;
  if (n_tok == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = (int)n_tok;
  if (dtype == kFloat32 && vec == 4) {
    launch_k<float, 4>(x_wide, x_tilde, p, g, sel, out, n, K, d, s);
  } else if (dtype == kFloat32 && vec == 1) {
    launch_k<float, 1>(x_wide, x_tilde, p, g, sel, out, n, K, d, s);
  } else if (dtype == kBFloat16 && vec == 8) {
    launch_k<__nv_bfloat16, 8>(x_wide, x_tilde, p, g, sel, out, n, K, d, s);
  } else if (dtype == kBFloat16 && vec == 1) {
    launch_k<__nv_bfloat16, 1>(x_wide, x_tilde, p, g, sel, out, n, K, d, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

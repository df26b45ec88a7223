// RWKV-6 "Finch" WKV recurrence for Hopper.
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan.py::rwkv6_wkv (Pallas
// body `_rwkv_kernel`). For every head row bh (a batch row and a head) and
// step t, with a (Dh, Dh) state S kept in f32:
//
//   out_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j]  = w_t[i] * S[i][j] + k_t[i] * v_t[j]
//
// r, k, v, w and out are (BH, S, Dh) in float32 or bf16; u is (U, Dh) in
// float32 or bf16, row bh % U serving head row bh; the state is (BH, Dh,
// Dh) float32, row-major [i][j].
//
// What bounds it on the H100: at one step (S = 1, the decode step) the
// bytes of the state, read once and written once, 2 * Dh^2 * 4 bytes per
// head row against ~5 Dh^2 operations; over a long sequence (the forward,
// S = 512) its 5 * S * Dh^2 f32 operations per head row, at 67 TFLOP/s,
// since the state never leaves the block.
//
// Design, simple first: one block per head row and Dh threads. Thread j
// keeps column j of the state in Dh registers for the whole sequence, so
// the state is read from and written to device memory once per call,
// whatever S is. Each step stages r_t, k_t and w_t in shared memory (every
// thread reads all Dh of them) and keeps v_t[j] in a register; the next
// step's four values are loaded into registers while this step computes,
// in their storage type: converting them at once would wait on the load.
// The TPU kernel's chunking of S only tiled VMEM: here any S runs.
//
// The final state may be written IN PLACE over the initial state
// (state_out == state_in): thread j reads column j of the state before
// its first step and writes the same column after its last, and no other
// thread touches that column, so the decode step updates its cache leaf
// without a copy. state_in == nullptr starts from zeros, with the same
// arithmetic as a zero state.

#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

template <typename T, typename TU, int DH>
__global__ void __launch_bounds__(DH)
    rwkv6_wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ w,
                     const TU* __restrict__ u, const float* state_in,
                     float* state_out, T* __restrict__ out, int S,
                     int u_rows) {
  __shared__ float sr[DH];
  __shared__ float sk[DH];
  __shared__ float sw[DH];
  __shared__ float su[DH];
  const int bh = blockIdx.x;
  const int j = threadIdx.x;
  su[j] = to_f32(u[(long long)(bh % u_rows) * DH + j]);

  const long long sbase = (long long)bh * DH * DH + j;
  float s[DH];
#pragma unroll
  for (int i = 0; i < DH; ++i)
    s[i] = state_in != nullptr ? state_in[sbase + (long long)i * DH] : 0.f;

  const long long base = (long long)bh * S * DH + j;
  T nr{}, nk{}, nw{}, nv{};
  if (S > 0) {
    nr = r[base];
    nk = k[base];
    nw = w[base];
    nv = v[base];
  }
  for (int t = 0; t < S; ++t) {
    __syncthreads();  // every thread is done reading step t-1's values
    sr[j] = to_f32(nr);
    sk[j] = to_f32(nk);
    sw[j] = to_f32(nw);
    const float vj = to_f32(nv);
    __syncthreads();
    const long long o = base + (long long)t * DH;
    if (t + 1 < S) {  // in flight while this step computes
      nr = r[o + DH];
      nk = k[o + DH];
      nw = w[o + DH];
      nv = v[o + DH];
    }
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < DH; ++i) {
      const float kv = sk[i] * vj;
      acc += sr[i] * (s[i] + su[i] * kv);
      s[i] = sw[i] * s[i] + kv;
    }
    out[o] = from_f32<T>(acc);
  }
#pragma unroll
  for (int i = 0; i < DH; ++i) state_out[sbase + (long long)i * DH] = s[i];
}

template <typename T, typename TU, int DH>
void launch(const void* r, const void* k, const void* v, const void* w,
            const void* u, const float* state_in, float* state_out,
            void* out, int BH, int S, int u_rows, cudaStream_t stream) {
  rwkv6_wkv_kernel<T, TU, DH><<<BH, DH, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const TU*>(u), state_in, state_out, static_cast<T*>(out),
      S, u_rows);
}

template <typename T, typename TU>
int launch_dh(const void* r, const void* k, const void* v, const void* w,
              const void* u, const float* state_in, float* state_out,
              void* out, int BH, int S, int Dh, int u_rows,
              cudaStream_t stream) {
  switch (Dh) {
    case 16:
      launch<T, TU, 16>(r, k, v, w, u, state_in, state_out, out, BH, S,
                        u_rows, stream);
      break;
    case 32:
      launch<T, TU, 32>(r, k, v, w, u, state_in, state_out, out, BH, S,
                        u_rows, stream);
      break;
    case 64:
      launch<T, TU, 64>(r, k, v, w, u, state_in, state_out, out, BH, S,
                        u_rows, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace
}  // namespace repro_torch

// r, k, v, w, out: (BH, S, Dh) contiguous in `dtype`; u: (u_rows, Dh)
// contiguous in `u_dtype`, BH a multiple of u_rows; state_in: (BH, Dh, Dh)
// contiguous float32 or nullptr (zeros); state_out: (BH, Dh, Dh) float32,
// may equal state_in. Dh is 16, 32 or 64. Returns the CUDA error code of
// the launch (0 = success).
extern "C" int rwkv6_wkv_launch(const void* r, const void* k, const void* v,
                                const void* w, const void* u,
                                const float* state_in, float* state_out,
                                void* out, int BH, int S, int Dh, int u_rows,
                                int dtype, int u_dtype, void* stream) {
  using namespace repro_torch;
  if (BH < 0 || S < 0 || u_rows < 1 || BH % u_rows != 0)
    return (int)cudaErrorInvalidValue;
  if (BH == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == kFloat32 && u_dtype == kFloat32) {
    err = launch_dh<float, float>(r, k, v, w, u, state_in, state_out, out,
                                  BH, S, Dh, u_rows, st);
  } else if (dtype == kFloat32 && u_dtype == kBFloat16) {
    err = launch_dh<float, __nv_bfloat16>(r, k, v, w, u, state_in,
                                          state_out, out, BH, S, Dh, u_rows,
                                          st);
  } else if (dtype == kBFloat16 && u_dtype == kFloat32) {
    err = launch_dh<__nv_bfloat16, float>(r, k, v, w, u, state_in,
                                          state_out, out, BH, S, Dh, u_rows,
                                          st);
  } else if (dtype == kBFloat16 && u_dtype == kBFloat16) {
    err = launch_dh<__nv_bfloat16, __nv_bfloat16>(
        r, k, v, w, u, state_in, state_out, out, BH, S, Dh, u_rows, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

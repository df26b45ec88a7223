// Length-aware single-token GQA decode attention over slot caches, for
// Hopper.
//
// Replaces the TPU kernel
// repro/kernels/ragged_decode_attention.py::ragged_decode_attention
// (Pallas body `_kernel`, unquantized). For slot b and kv head h, with
// len = lengths[b] and the `rep` query heads h*rep .. h*rep+rep-1 that read
// kv head h (the q[:, 0].reshape(B, Hk, rep, Dh) grouping):
//
//   out[b, h, r] = softmax_t(q[b, h, r] . k[b, t, h] * scale) @ v[b, t, h],
//                  over rows t < len only; len = 0 gives exact zeros.
//
// What bounds it on the H100: bytes. Each visited kv row is read once for
// all `rep` queries (2*Dh*rep flops per Dh elements read), so the least time
// is sum_b len_b * Hk * Dh * 2 (k and v) * bytes / 3.35 TB/s. Rows at or
// past a slot's length are never read, which is the point of the kernel:
// the dense path reads the whole cache slice.
//
// Design, simple first: grid (B, Hk), 128 threads (4 warps) per block.
// The block stages its `rep` queries in shared memory as f32, then walks
// rows 0..len-1 in tiles of 64 with an f32 online softmax (running max,
// denominator, accumulator):
//   1. scores: warp w scores rows w, w+4, ...; each lane holds Dh/32 of the
//      row and a warp shuffle reduces the rep dot products;
//   2. softmax: warp w updates query r = w, w+4, ...: tile max, rescale
//      factor, exponentials written back over the scores, denominator;
//   3. values: thread i owns output features i and i+128 for every query,
//      so each v element is loaded once, coalesced across the warp.
// The cache is read in place through its batch and row strides (the last
// two dims must be contiguous), so the (B, Tb) read slice of a layer cache
// is never copied.
//
// Known limit: the grid has only B*Hk blocks (64 at 8 slots x 8 kv heads
// on 132 SMs), and each block walks its rows serially. A split-K
// (flash-decoding) grid that spreads one slot's rows over several blocks
// and merges their partial softmax states is the later redesign.

#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;
constexpr int kMaxRep = 8;
constexpr int kMaxDh = 256;
constexpr int kDimsPerLane = kMaxDh / 32;
constexpr int kDimsPerThread = kMaxDh / kThreads;
constexpr float kNegInf = -1e30f;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ragged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const int* __restrict__ lengths, T* __restrict__ out,
                         int Hk, int rep, int Dh, int T_rows, long long k_sb,
                         long long k_st, long long v_sb, long long v_st,
                         float scale) {
  __shared__ float q_s[kMaxRep * kMaxDh];
  __shared__ float s_s[kMaxRep][kTile];
  __shared__ float m_s[kMaxRep];
  __shared__ float l_s[kMaxRep];
  __shared__ float a_s[kMaxRep];

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int len = max(0, min(lengths[b], T_rows));

  const long long qo = ((long long)b * Hk + h) * rep * Dh;
  for (int i = tid; i < rep * Dh; i += kThreads) q_s[i] = to_f32(q[qo + i]);
  if (tid < kMaxRep) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kMaxRep][kDimsPerThread];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i) acc[r][i] = 0.f;
  }
  const T* kb = k + (long long)b * k_sb + (long long)h * Dh;
  const T* vb = v + (long long)b * v_sb + (long long)h * Dh;
  __syncthreads();

  for (int t0 = 0; t0 < len; t0 += kTile) {
    const int n = min(kTile, len - t0);

    // 1. scores of this tile's rows against every grouped query
    for (int row = warp; row < n; row += kWarps) {
      const T* kr = kb + (long long)(t0 + row) * k_st;
      float kv[kDimsPerLane];
#pragma unroll
      for (int e = 0; e < kDimsPerLane; ++e) {
        const int dd = lane + 32 * e;
        kv[e] = dd < Dh ? to_f32(kr[dd]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        if (r < rep) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < kDimsPerLane; ++e) {
            const int dd = lane + 32 * e;
            if (dd < Dh) part += q_s[r * Dh + dd] * kv[e];
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            part += __shfl_xor_sync(0xffffffffu, part, off);
          if (lane == 0) s_s[r][row] = part * scale;
        }
      }
    }
    __syncthreads();

    // 2. online-softmax update, one warp per query
    for (int r = warp; r < rep; r += kWarps) {
      float mx = kNegInf;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, s_s[r][j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float pj = expf(s_s[r][j] - m_new);
        s_s[r][j] = pj;
        sum += pj;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // 3. rescale the accumulators and add this tile's weighted values
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r < rep) {
        const float alpha = a_s[r];
#pragma unroll
        for (int i = 0; i < kDimsPerThread; ++i) acc[r][i] *= alpha;
      }
    }
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const T* vr = vb + (long long)(t0 + j) * v_st;
#pragma unroll
      for (int i = 0; i < kDimsPerThread; ++i) {
        const int dd = tid + kThreads * i;
        if (dd < Dh) {
          const float vv = to_f32(vr[dd]);
#pragma unroll
          for (int r = 0; r < kMaxRep; ++r) {
            if (r < rep) acc[r][i] += s_s[r][j] * vv;
          }
        }
      }
    }
    __syncthreads();  // s_s and a_s are rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    if (r < rep) {
      const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
#pragma unroll
      for (int i = 0; i < kDimsPerThread; ++i) {
        const int dd = tid + kThreads * i;
        if (dd < Dh) out[qo + r * Dh + dd] = from_f32<T>(acc[r][i] * inv);
      }
    }
  }
}

template <typename T>
void launch(const void* q, const void* k, const void* v, const void* lengths,
            void* out, int B, int Hk, int rep, int Dh, int T_rows,
            long long k_sb, long long k_st, long long v_sb, long long v_st,
            float scale, cudaStream_t stream) {
  const dim3 grid(B, Hk);
  ragged_decode_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<T*>(out), Hk, rep, Dh, T_rows, k_sb, k_st, v_sb, v_st,
      scale);
}

}  // namespace
}  // namespace repro_torch

// q (B, Hk, rep, Dh) contiguous; k, v (B, T, Hk, Dh) with element strides
// k_sb/v_sb (batch) and k_st/v_st (row), heads and features contiguous;
// lengths (B,) int32; out (B, Hk, rep, Dh) contiguous, all in `dtype`
// except lengths. Returns the CUDA error code of the launch (0 = success).
extern "C" int ragged_decode_attention_launch(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, int B, int Hk, int rep, int Dh, int T_rows, long long k_sb,
    long long k_st, long long v_sb, long long v_st, float scale, int dtype,
    void* stream) {
  using namespace repro_torch;
  if (B < 0 || Hk < 1 || rep < 1 || rep > kMaxRep || Dh < 1 ||
      Dh > kMaxDh || T_rows < 0 || Hk > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    launch<float>(q, k, v, lengths, out, B, Hk, rep, Dh, T_rows, k_sb, k_st,
                  v_sb, v_st, scale, s);
  } else if (dtype == kBFloat16) {
    launch<__nv_bfloat16>(q, k, v, lengths, out, B, Hk, rep, Dh, T_rows, k_sb,
                          k_st, v_sb, v_st, scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

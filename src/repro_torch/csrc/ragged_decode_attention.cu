// Length-aware single-token GQA decode attention over slot caches or a
// paged row pool, for Hopper, over float caches or int8 / float8_e4m3fn
// codes with per-row f32 scales.
//
// Replaces two TPU kernels of repro/kernels/ragged_decode_attention.py
// (Pallas body `_kernel`, unquantized and quantized):
//   ragged_decode_attention        (:210) over contiguous slot caches, and
//   paged_ragged_decode_attention  (:122) over batchless row pools read
//                                  through a per-slot block table.
// For slot b and kv head h, with len = lengths[b] and the `rep` query heads
// h*rep .. h*rep+rep-1 that read kv head h (the q[:, 0].reshape(B, Hk, rep,
// Dh) grouping):
//
//   out[b, h, r] = softmax_t(q[b, h, r] . k[b, t, h] * scale) @ v[b, t, h],
//                  over rows t < len only; len = 0 gives exact zeros.
//
// In the paged pool, row t of slot b lives at physical row
// bt[b, t / page] * page + t % page. With codes, k[b, t, h] stands for
// code * k_scale[b, t, h] in f32 (v likewise), dequantized as each row is
// loaded, as the Pallas body does at :83-87: the dequantized cache never
// exists in device memory.
//
// What bounds it on the H100: bytes. Each visited kv row is read once for
// all `rep` queries (2*Dh*rep flops per Dh elements read), so the least time
// is sum_b len_b * Hk * (Dh * 2 (k and v) * bytes + 2 * 4 scale bytes with
// codes) / 3.35 TB/s, for both entry points (the paged one adds
// ceil(len_b / page) int32 table entries). Rows at or past a slot's length
// are never read, which is the point of the kernel: the dense path reads
// the whole cache slice.
//
// Design, simple first: grid (B, Hk), 128 threads (4 warps) per block.
// The block stages its `rep` queries in shared memory as f32, then walks
// rows 0..len-1 in tiles of 64 with an f32 online softmax (running max,
// denominator, accumulator):
//   0. codes only: the tile's <= 64 k and v row scales, staged in shared
//      memory once;
//   1. scores: warp w scores rows w, w+4, ...; each lane holds Dh/32 of the
//      row (times its scale, for codes) and a warp shuffle reduces the rep
//      dot products;
//   2. softmax: warp w updates query r = w, w+4, ...: tile max, rescale
//      factor, exponentials written back over the scores, denominator;
//   3. values: thread i owns output features i and i+128 for every query,
//      so each v element is loaded once, coalesced across the warp (and
//      multiplied by its row's scale, for codes).
// The body `attend` is one template over the q/out type T, the k/v
// storage (KV: float32 or bfloat16 values, int8 or e4m3 codes) and how
// row t's offset from the (slot, head) base is found: SlotRows steps by
// the cache's row stride, reading the cache and its scales in place
// through their batch and row strides (the last two dims of k/v and the
// last dim of the scales must be contiguous), so the (B, Tb) read slice
// of a layer cache is never copied; PagedRows looks the row's page up in
// the slot's block-table row, which the block stages in shared memory
// once: the ceil(len/page) entries it needs and no more, since entries
// past those are 0 and alias a live page of another slot. Both entry
// points therefore run the same arithmetic in the same order, and the
// paged result on the same rows is bitwise equal to the contiguous one,
// codes or not. The float instantiations with k/v stored in q's type do
// exactly what they did before codes were added. Offsets are 64-bit.
//
// Known limits: the grid has only B*Hk blocks (64 at 8 slots x 8 kv heads
// on 132 SMs), each block walks its rows serially, and a lane loads one
// element (one byte, for codes) at a time. A split-K (flash-decoding) grid
// that spreads one slot's rows over several blocks and merges their
// partial softmax states, with 16-byte loads, is the later redesign, for
// both entry points and every storage.

#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;
constexpr int kMaxRep = 8;
constexpr int kMaxDh = 256;
constexpr int kMaxTablePages = 2048;
constexpr int kDimsPerLane = kMaxDh / 32;
constexpr int kDimsPerThread = kMaxDh / kThreads;
constexpr float kNegInf = -1e30f;

// k/v storage: the element type and its value as f32. Codes carry a
// per-row scale that the body multiplies in after the load.
template <typename E>
struct FloatKV {
  using Elem = E;
  static constexpr bool kScaled = false;
  static __device__ __forceinline__ float load(E x) { return to_f32(x); }
};
struct Int8KV {
  using Elem = uint8_t;
  static constexpr bool kScaled = true;
  static __device__ __forceinline__ float load(uint8_t c) {
    return int8_to_f32(c);
  }
};
struct E4m3KV {
  using Elem = uint8_t;
  static constexpr bool kScaled = true;
  static __device__ __forceinline__ float load(uint8_t c) {
    return e4m3_to_f32(c);
  }
};

// Element offsets of row t in a contiguous slot cache (k, v) and in its
// scales (s).
struct SlotRows {
  long long k_st, v_st, s_st;
  __device__ __forceinline__ long long k_off(int t) const {
    return (long long)t * k_st;
  }
  __device__ __forceinline__ long long v_off(int t) const {
    return (long long)t * v_st;
  }
  __device__ __forceinline__ long long s_off(int t) const {
    return (long long)t * s_st;
  }
};

// Element offsets of logical row t in a paged row pool and its scales.
struct PagedRows {
  long long k_st, v_st, s_st;
  const int* table;  // the slot's block-table row, in shared memory
  int page;
  __device__ __forceinline__ long long phys(int t) const {
    return (long long)table[t / page] * page + t % page;
  }
  __device__ __forceinline__ long long k_off(int t) const {
    return phys(t) * k_st;
  }
  __device__ __forceinline__ long long v_off(int t) const {
    return phys(t) * v_st;
  }
  __device__ __forceinline__ long long s_off(int t) const {
    return phys(t) * s_st;
  }
};

// The online-softmax body of one (slot, kv head) block. q and out point at
// the block's `rep` grouped queries and outputs, kb and vb at row 0 of its
// kv head, ksb and vsb at row 0 of its scales (read only for codes); rows
// 0..len-1 are visited. Any shared state the Rows object reads must be
// written before the call: the body's first barrier orders it before the
// first row access.
template <typename T, typename KV, typename Rows>
__device__ __forceinline__ void attend(const T* __restrict__ q,
                                       const typename KV::Elem* __restrict__ kb,
                                       const typename KV::Elem* __restrict__ vb,
                                       const float* __restrict__ ksb,
                                       const float* __restrict__ vsb,
                                       Rows rows, int len, T* __restrict__ out,
                                       int rep, int Dh, float scale) {
  using Elem = typename KV::Elem;
  __shared__ float q_s[kMaxRep * kMaxDh];
  __shared__ float s_s[kMaxRep][kTile];
  __shared__ float m_s[kMaxRep];
  __shared__ float l_s[kMaxRep];
  __shared__ float a_s[kMaxRep];
  __shared__ float ks_s[kTile];
  __shared__ float vs_s[kTile];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < rep * Dh; i += kThreads) q_s[i] = to_f32(q[i]);
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
  __syncthreads();

  for (int t0 = 0; t0 < len; t0 += kTile) {
    const int n = min(kTile, len - t0);

    // 0. the tile's row scales; the previous tile's closing barrier
    // ordered its last reads of ks_s / vs_s before these writes
    if constexpr (KV::kScaled) {
      for (int i = tid; i < n; i += kThreads) {
        const long long so = rows.s_off(t0 + i);
        ks_s[i] = ksb[so];
        vs_s[i] = vsb[so];
      }
      __syncthreads();
    }

    // 1. scores of this tile's rows against every grouped query
    for (int row = warp; row < n; row += kWarps) {
      const Elem* kr = kb + rows.k_off(t0 + row);
      float kv[kDimsPerLane];
#pragma unroll
      for (int e = 0; e < kDimsPerLane; ++e) {
        const int dd = lane + 32 * e;
        kv[e] = dd < Dh ? KV::load(kr[dd]) : 0.f;
      }
      if constexpr (KV::kScaled) {
        const float ks = ks_s[row];
#pragma unroll
        for (int e = 0; e < kDimsPerLane; ++e) kv[e] *= ks;
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
      const Elem* vr = vb + rows.v_off(t0 + j);
#pragma unroll
      for (int i = 0; i < kDimsPerThread; ++i) {
        const int dd = tid + kThreads * i;
        if (dd < Dh) {
          float vv = KV::load(vr[dd]);
          if constexpr (KV::kScaled) vv *= vs_s[j];
#pragma unroll
          for (int r = 0; r < kMaxRep; ++r) {
            if (r < rep) acc[r][i] += s_s[r][j] * vv;
          }
        }
      }
    }
    __syncthreads();  // s_s, a_s and the scales are rewritten next tile
  }

#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    if (r < rep) {
      const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
#pragma unroll
      for (int i = 0; i < kDimsPerThread; ++i) {
        const int dd = tid + kThreads * i;
        if (dd < Dh) out[r * Dh + dd] = from_f32<T>(acc[r][i] * inv);
      }
    }
  }
}

template <typename T, typename KV>
__global__ void __launch_bounds__(kThreads)
    ragged_decode_kernel(const T* __restrict__ q,
                         const typename KV::Elem* __restrict__ k,
                         const typename KV::Elem* __restrict__ v,
                         const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale,
                         const int* __restrict__ lengths, T* __restrict__ out,
                         int Hk, int rep, int Dh, int T_rows, long long k_sb,
                         long long k_st, long long v_sb, long long v_st,
                         long long s_sb, long long s_st, float scale) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int len = max(0, min(lengths[b], T_rows));
  const long long qo = ((long long)b * Hk + h) * rep * Dh;
  const long long so = (long long)b * s_sb + h;
  attend<T, KV>(q + qo, k + (long long)b * k_sb + (long long)h * Dh,
                v + (long long)b * v_sb + (long long)h * Dh,
                KV::kScaled ? k_scale + so : nullptr,
                KV::kScaled ? v_scale + so : nullptr,
                SlotRows{k_st, v_st, s_st}, len, out + qo, rep, Dh, scale);
}

template <typename T, typename KV>
__global__ void __launch_bounds__(kThreads)
    paged_ragged_decode_kernel(const T* __restrict__ q,
                               const typename KV::Elem* __restrict__ k_pool,
                               const typename KV::Elem* __restrict__ v_pool,
                               const float* __restrict__ k_scale,
                               const float* __restrict__ v_scale,
                               const int* __restrict__ lengths,
                               const int* __restrict__ table,
                               T* __restrict__ out, int Hk, int rep, int Dh,
                               int t_max, int page, long long table_sb,
                               long long k_st, long long v_st, long long s_st,
                               float scale) {
  __shared__ int table_s[kMaxTablePages];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int len = max(0, min(lengths[b], t_max));
  // the entries rows 0..len-1 need, and no more (later ones alias pages
  // of other slots); ordered before use by the body's first barrier
  const int n_pages = (len + page - 1) / page;
  const int* bt = table + (long long)b * table_sb;
  for (int i = threadIdx.x; i < n_pages; i += kThreads) table_s[i] = bt[i];
  const long long qo = ((long long)b * Hk + h) * rep * Dh;
  attend<T, KV>(q + qo, k_pool + (long long)h * Dh,
                v_pool + (long long)h * Dh,
                KV::kScaled ? k_scale + h : nullptr,
                KV::kScaled ? v_scale + h : nullptr,
                PagedRows{k_st, v_st, s_st, table_s, page}, len, out + qo,
                rep, Dh, scale);
}

bool bad_shape(int B, int Hk, int rep, int Dh) {
  return B < 0 || Hk < 1 || rep < 1 || rep > kMaxRep || Dh < 1 ||
         Dh > kMaxDh || Hk > 65535;
}

template <typename X>
struct Tag {
  using type = X;
};

// f(Tag<T>, Tag<KV>) for the q dtype and k/v storage codes of common.cuh;
// false for a code the kernels do not take.
template <typename T, typename F>
bool with_kv(int kv_dtype, F&& f) {
  switch (kv_dtype) {
    case kFloat32:
      f(Tag<T>{}, Tag<FloatKV<float>>{});
      return true;
    case kBFloat16:
      f(Tag<T>{}, Tag<FloatKV<__nv_bfloat16>>{});
      return true;
    case kInt8:
      f(Tag<T>{}, Tag<Int8KV>{});
      return true;
    case kFloat8E4M3:
      f(Tag<T>{}, Tag<E4m3KV>{});
      return true;
    default:
      return false;
  }
}

template <typename F>
bool with_types(int dtype, int kv_dtype, F&& f) {
  if (dtype == kFloat32) return with_kv<float>(kv_dtype, f);
  if (dtype == kBFloat16) return with_kv<__nv_bfloat16>(kv_dtype, f);
  return false;
}

bool is_code(int kv_dtype) {
  return kv_dtype == kInt8 || kv_dtype == kFloat8E4M3;
}

}  // namespace
}  // namespace repro_torch

// q (B, Hk, rep, Dh) contiguous, in `dtype` (float32 or bfloat16); k, v
// (B, T, Hk, Dh) in `kv_dtype` (float32, bfloat16, int8 or e4m3 codes)
// with element strides k_sb/v_sb (batch) and k_st/v_st (row), heads and
// features contiguous; with codes, k_scale and v_scale (B, T, Hk) float32
// with element strides s_sb (batch) and s_st (row), heads contiguous (null
// and ignored for float k/v); lengths (B,) int32; out (B, Hk, rep, Dh)
// contiguous in `dtype`. Returns the CUDA error code of the launch (0 =
// success).
extern "C" int ragged_decode_attention_launch(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* lengths, void* out, int B, int Hk,
    int rep, int Dh, int T_rows, long long k_sb, long long k_st,
    long long v_sb, long long v_st, long long s_sb, long long s_st,
    float scale, int dtype, int kv_dtype, void* stream) {
  using namespace repro_torch;
  if (bad_shape(B, Hk, rep, Dh) || T_rows < 0 ||
      (is_code(kv_dtype) && (k_scale == nullptr || v_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(B, Hk);
  const bool ok = with_types(dtype, kv_dtype, [&](auto qt, auto kvt) {
    using T = typename decltype(qt)::type;
    using KV = typename decltype(kvt)::type;
    using E = typename KV::Elem;
    ragged_decode_kernel<T, KV><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(q), static_cast<const E*>(k),
        static_cast<const E*>(v), static_cast<const float*>(k_scale),
        static_cast<const float*>(v_scale), static_cast<const int*>(lengths),
        static_cast<T*>(out), Hk, rep, Dh, T_rows, k_sb, k_st, v_sb, v_st,
        s_sb, s_st, scale);
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// q (B, Hk, rep, Dh) contiguous, in `dtype`; k_pool, v_pool (R, Hk, Dh) in
// `kv_dtype` with row strides k_st/v_st in elements, heads and features
// contiguous; with codes, k_scale and v_scale (R, Hk) float32 with row
// stride s_st, heads contiguous (null and ignored for float pools);
// lengths (B,) int32; table (B, npages) int32 with row stride table_sb,
// npages >= ceil(t_max / page), at most 2048 of them read; out (B, Hk, rep,
// Dh) contiguous. Returns the CUDA error code of the launch (0 = success).
extern "C" int paged_ragged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* lengths,
    const void* table, void* out, int B, int Hk, int rep, int Dh, int t_max,
    int page, long long table_sb, long long k_st, long long v_st,
    long long s_st, float scale, int dtype, int kv_dtype, void* stream) {
  using namespace repro_torch;
  if (bad_shape(B, Hk, rep, Dh) || t_max < 0 || page < 1 ||
      (t_max + page - 1) / page > kMaxTablePages ||
      (is_code(kv_dtype) && (k_scale == nullptr || v_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(B, Hk);
  const bool ok = with_types(dtype, kv_dtype, [&](auto qt, auto kvt) {
    using T = typename decltype(qt)::type;
    using KV = typename decltype(kvt)::type;
    using E = typename KV::Elem;
    paged_ragged_decode_kernel<T, KV><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(q), static_cast<const E*>(k_pool),
        static_cast<const E*>(v_pool), static_cast<const float*>(k_scale),
        static_cast<const float*>(v_scale), static_cast<const int*>(lengths),
        static_cast<const int*>(table), static_cast<T*>(out), Hk, rep, Dh,
        t_max, page, table_sb, k_st, v_st, s_st, scale);
  });
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

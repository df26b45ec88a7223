// Length-aware single-token GQA decode attention over slot caches or a
// paged row pool, for Hopper, over float caches or int8 / float8_e4m3fn
// codes with per-row f32 scales: a split-K (flash-decoding) kernel and a
// merge kernel.
//
// Replaces two TPU kernels of repro/kernels/ragged_decode_attention.py
// (Pallas bodies `_kernel` and `_paged_kernel`, unquantized and quantized):
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
// code * k_scale[b, t, h] in f32 (v likewise), as the Pallas body has it at
// :83-87; the dequantized cache never exists in device memory.
//
// What bounds it on the H100: bytes. Each visited kv row is read once for
// all `rep` queries (4*Dh*rep flops per 2*Dh elements read), so the least
// time is sum_b len_b * Hk * (Dh * 2 (k and v) * bytes + 2 * 4 scale bytes
// with codes) / 3.35 TB/s, for both entry points (the paged one adds
// ceil(len_b / page) int32 table entries). Rows at or past a slot's length
// are never read. At decode shapes (a few thousand rows, ~10 MB) that
// bound is a few microseconds, so what the design fights is latency: it
// spreads the rows over many blocks and keeps each block's bytes in
// flight at once.
//
// Design.
//   Split. The grid is (B, Hk, n_split): block s of (b, h) attends rows
//   [s*span, min((s+1)*span, len)); a block whose span starts at or past
//   len returns at once. span is the constant kSpan = 128 (chosen from 64,
//   128 and 256 by kernels/span_sweep.py's timings; see PERF.md), and
//   n_split = ceil(rows / span) with rows = T (contiguous) or t_max
//   (paged). The partition depends on the row index alone.
//   Ring. 256 threads move the span through a ring of shared-memory
//   stages, each one tile of k or of v: `tile` rows (64, 32, 16 or 8, the
//   largest of which four stages fit 96 KB at this Dh and storage width),
//   as many stages as fit 96 KB (4 to 8), but never more than the
//   span's 2 * ceil(span / tile) items. The items go k tiles first, then
//   v tiles, by 16-byte cp.async copies; the prologue issues as many
//   items as there are stages (the whole span, at Dh 128 in bf16 or
//   codes), and a stage is refilled as soon as its item has been used. Rows whose chunks cannot all be
//   copied 16 bytes at a time (Dh * element size not a multiple of 16, or
//   a misaligned base or stride) take a scalar path, chunk by chunk, that
//   also zero-fills the row's padding. Rows are padded so that the score
//   pass's shared-memory reads are free of bank conflicts.
//   Per k tile, as it lands: thread (row j, part p) dots 16-byte chunks p,
//   p + ds, ... (ds = 256 / tile adjacent lanes per row) of k row j with
//   the `rep` queries, staged once in shared memory as f32 (broadcast
//   reads), and the ds lanes add their partial sums by shuffles; the
//   score, times the row's k scale for codes, times `scale`, goes to a
//   rep x span buffer. After the last k tile, one softmax over the span,
//   a warp per query: running max m, denominator l, and the weights
//   (times the row's v scale, for codes) in place of the scores. Per v
//   tile, as it lands: thread (feature unit u, row group g) owns 4 output
//   features and adds rows g, g + G, ... Codes are multiplied by their f32
//   scale after the load, as the Pallas body does, folded into the score
//   and the weight (one multiply per row instead of one per element).
//   Merge. Each block writes its f32 partial state (the unnormalised
//   accumulator of Dh features, then m and l, for each of the `rep`
//   queries) to a workspace of (B, Hk, n_split, rep, Dh + 2) floats that
//   the wrapper allocates without a memset. The merge kernel, grid (B,
//   Hk), combines the non-empty spans of slot b in span order:
//   M = max m_s, w_s = exp(m_s - M), out = sum_s w_s acc_s / max(sum_s w_s
//   l_s, 1e-30); with no span (len 0) it writes exact zeros. The order is
//   fixed, so results are deterministic run to run. (A one-launch variant,
//   in which the last block of (b, h) to finish merges through an atomic
//   counter, measured slower on the H100 and is not kept.)
// Bitwise rule: both entry points run the same body through a row-address
// policy (SlotRows reads the cache and its scales in place through their
// batch and row strides; PagedRows reads the physical row of each of the
// span's rows, computed once per block from the table entries of the
// span's own pages into shared memory), with tile, pitch and stages that
// depend on Dh, rep, the span and the storage type alone. So the paged
// result on the same rows is bitwise equal to the contiguous one,
// whatever bucket (T or t_max) each is read through.
//
// Known limits: rep <= 8 and Dh <= 512 (a value-pass thread owns at most 4
// features; every reference config fits: gemma3-4b has Dh 320, granite
// rep 4); n_split <= 65535 (rows up to 8M at span 128); Hk <= 65535. Two
// launches per call. The merge walks a slot's spans one after another, so
// a very long slot (hundreds of spans) spends most of its time there.
// Scores and values run on the CUDA cores in f32: at rep <= 8 the work is
// a bytes-bound GEMV, not a tensor-core product.

#include <cuda_fp16.h>
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRep = 8;
constexpr int kMaxDh = 512;
constexpr int kUnit = 4;                 // features a value-pass thread owns
constexpr int kMinStages = 4;            // ring stages, a k or v tile each
constexpr int kMaxStages = 8;
constexpr int kRingBudget = 96 * 1024;   // bytes of the ring
constexpr int kMaxTile = 64;
constexpr int kMinTile = 8;
// rows a split block attends; ragged_decode_attention.SPAN mirrors it, and
// a call whose n_split was computed with another span is refused
constexpr int kSpan = 128;
static_assert(kSpan <= kThreads, "the scales load one row a thread");
constexpr float kNegInf = -1e30f;

// k/v storage: the raw element as stored, and `unpack`, which turns one
// 32-bit word of them into f32 values. Codes carry a per-row scale that
// the body multiplies in after the load. The decode loop converts every
// element it reads, so the unpacking avoids the slow per-element
// conversion instructions where integer arithmetic does as well (bf16,
// int8) and converts e4m3 codes in pairs.
struct F32KV {
  using Elem = float;
  static constexpr bool kScaled = false;
  static __device__ __forceinline__ void unpack(uint32_t w, float* f) {
    f[0] = __uint_as_float(w);
  }
};
struct BF16KV {
  using Elem = uint16_t;  // the bfloat16 bit pattern
  static constexpr bool kScaled = false;
  static __device__ __forceinline__ void unpack(uint32_t w, float* f) {
    f[0] = __uint_as_float(w << 16);  // exact
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
};
struct Int8KV {
  using Elem = uint8_t;
  static constexpr bool kScaled = true;
  // byte b of value v sits, as b ^ 0x80 = v + 128, in the mantissa of
  // 2^23; subtracting 2^23 + 128 leaves v exactly
  static __device__ __forceinline__ void unpack(uint32_t w, float* f) {
    const uint32_t x = w ^ 0x80808080u;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[i] = __uint_as_float(__byte_perm(x, 0x4b000000u, 0x7540 + i)) -
             8388736.f;
  }
};
struct E4m3KV {
  using Elem = uint8_t;
  static constexpr bool kScaled = true;
  // two codes at a time through the hardware's e4m3x2 -> f16x2
  // conversion, exact for every code (NaN included), then f16 -> f32
  static __device__ __forceinline__ void unpack(uint32_t w, float* f) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const __half2 h = __half2(__nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>(w >> (16 * i)), __NV_E4M3));
      const float2 x = __half22float2(h);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
};

template <int kBytes>
struct RawOf;
template <>
struct RawOf<4> {
  using type = uint32_t;
};
template <>
struct RawOf<8> {
  using type = uint2;
};
template <>
struct RawOf<16> {
  using type = uint4;
};

// The kN stored elements at shared address p (aligned to their size) as
// f32, through one 4-, 8- or 16-byte load.
template <typename KV, int kN>
__device__ __forceinline__ void load_f32(const unsigned char* p, float* f) {
  constexpr int kPerWord = 4 / static_cast<int>(sizeof(typename KV::Elem));
  constexpr int kWords = kN / kPerWord;
  using Raw = typename RawOf<4 * kWords>::type;
  union {
    Raw raw;
    uint32_t w[kWords];
  } u;
  u.raw = *reinterpret_cast<const Raw*>(p);
#pragma unroll
  for (int i = 0; i < kWords; ++i) KV::unpack(u.w[i], f + i * kPerWord);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}
// cp_async_wait for a pending count known at run time (0 .. kMaxStages-1)
__device__ __forceinline__ void cp_async_wait_at_most(int pending) {
  switch (pending) {
    case 7: cp_async_wait<7>(); break;
    case 6: cp_async_wait<6>(); break;
    case 5: cp_async_wait<5>(); break;
    case 4: cp_async_wait<4>(); break;
    case 3: cp_async_wait<3>(); break;
    case 2: cp_async_wait<2>(); break;
    case 1: cp_async_wait<1>(); break;
    default: cp_async_wait<0>(); break;
  }
}

__host__ __device__ __forceinline__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int* lengths;
  const int* table;   // paged only
  float* ws;          // (B, Hk, n_split, rep, Dh + 2) partial states
  void* out;
  int Hk, rep, Dh;
  int rows;           // T (contiguous) or t_max (paged)
  int n_split, page;
  long long k_sb, k_st, v_sb, v_st, s_sb, s_st, table_sb;
  float scale;
  // set by the launcher from Dh and the storage
  int tile, pitch, stages, smem;
};

// Byte offsets of the dynamic shared memory: the ring (reused for the
// row groups' accumulators at the end), the f32 queries, the span's
// scores (then its weights), its k and v scales and, for the paged entry
// point, the physical row of each of its rows.
struct Layout {
  int q, score, scales, phys, total;
};

__host__ __device__ __forceinline__ Layout layout(const Params& p) {
  const int rep = p.rep;
  constexpr int span = kSpan;
  Layout L;
  int ring = p.stages * p.tile * p.pitch;
  const int red = kMaxRep * kThreads * kUnit * 4;
  if (ring < red) ring = red;
  L.q = ring;
  L.score = L.q + rep * round_up(p.Dh, 16) * 4;
  L.scales = L.score + rep * span * 4;
  L.phys = L.scales + 2 * span * 4;
  L.total = L.phys + span * 4;
  return L;
}

// Physical row of row j of the block's span, in the slot cache (row t0 + j
// of the slot) or in the paged pool (through the block table, computed
// once per row into shared memory before the body runs).
struct SlotRows {
  int t0;
  __device__ __forceinline__ long long operator()(int j) const {
    return t0 + j;
  }
};
struct PagedRows {
  const int* phys;
  __device__ __forceinline__ long long operator()(int j) const {
    return phys[j];
  }
};

// Issue the copies of span rows j0 .. j0+nt-1 of one kv head base (k or
// v, row stride st) into one ring stage: 16-byte cp.async for every full,
// aligned chunk of a row; element by element (and zeros past Dh) for the
// rest. `vec` says that every chunk is full and aligned (a block-uniform
// fact of the base, the strides and Dh), which leaves a loop of address
// arithmetic and copies. Thread tid starts at row lj, chunk lc of the
// tile and steps kThreads chunks at a time (dj rows and dc chunks), so
// the loop divides nothing.
template <typename KV, typename Rows>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const typename KV::Elem* base,
                                          long long st, const Rows& rows,
                                          int j0, int nt, int Dh, int nchunk,
                                          int pitch, int lj, int lc, int dj,
                                          int dc, bool vec) {
  using Elem = typename KV::Elem;
  constexpr int kPer = 16 / static_cast<int>(sizeof(Elem));
  const int row_bytes = Dh * static_cast<int>(sizeof(Elem));
  if (vec) {
    for (int j = lj, c = lc; j < nt;) {
      cp_async16(dst + j * pitch + c * 16,
                 reinterpret_cast<const unsigned char*>(
                     base + rows(j0 + j) * st) + c * 16);
      j += dj;
      c += dc;
      if (c >= nchunk) {
        c -= nchunk;
        ++j;
      }
    }
    return;
  }
  for (int j = lj, c = lc; j < nt;) {
    const unsigned char* g =
        reinterpret_cast<const unsigned char*>(base + rows(j0 + j) * st) +
        c * 16;
    unsigned char* d = dst + j * pitch + c * 16;
    if (c * 16 + 16 <= row_bytes &&
        (reinterpret_cast<uintptr_t>(g) & 15) == 0) {
      cp_async16(d, g);
    } else {
      const Elem* ge = reinterpret_cast<const Elem*>(g);
      Elem* de = reinterpret_cast<Elem*>(d);
      const int e0 = c * kPer;
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        de[e] = e0 + e < Dh ? ge[e] : static_cast<Elem>(0);
    }
    j += dj;
    c += dc;
    if (c >= nchunk) {
      c -= nchunk;
      ++j;
    }
  }
}

// One block's span: rows 0 .. n-1 (n >= 1) of the span, found through
// `rows`, of kv head base kb / vb (scales ksb / vsb, read only for codes),
// against the block's `rep` grouped queries q; writes the f32 partial
// state to ws (rep x (Dh + 2): the accumulator, then m, then l). Shared
// state the Rows object reads must be written, and a barrier passed,
// before the call.
//
// The ring carries 2 * ntiles items through p.stages stages: the span's k
// tiles, then its v tiles. The first `stages` items are issued at once
// (all of a span of up to stages / 2 tiles); a stage is refilled as soon
// as its item is used. k tile i is scored as it lands; after the last,
// one softmax over the span; then each v tile is accumulated as it lands.
template <typename T, typename KV, typename Rows>
__device__ __forceinline__ void attend_span(const Params& p,
                                            unsigned char* smem,
                                            const T* __restrict__ q,
                                            const typename KV::Elem* kb,
                                            const typename KV::Elem* vb,
                                            const float* __restrict__ ksb,
                                            const float* __restrict__ vsb,
                                            const Rows& rows, int n,
                                            float* __restrict__ ws) {
  using Elem = typename KV::Elem;
  constexpr int kPer = 16 / static_cast<int>(sizeof(Elem));
  __shared__ float m_s[kMaxRep];
  __shared__ float l_s[kMaxRep];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rep = p.rep;
  const int Dh = p.Dh;
  const int tile = p.tile;
  const int pitch = p.pitch;
  constexpr int span = kSpan;
  const int nchunk = (Dh * static_cast<int>(sizeof(Elem)) + 15) / 16;
  const int dq = round_up(Dh, 16);
  const Layout L = layout(p);
  unsigned char* ring = smem;
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* sc = reinterpret_cast<float*>(smem + L.score);  // rep x span
  float* ks_s = reinterpret_cast<float*>(smem + L.scales);
  float* vs_s = ks_s + span;
  const int ntiles = (n + tile - 1) / tile;
  const int items = 2 * ntiles;
  // this thread's first (row, chunk) of a tile and its step
  const int lj = tid / nchunk;
  const int lc = tid - lj * nchunk;
  const int dj = kThreads / nchunk;
  const int dc = kThreads - dj * nchunk;
  const int stages = p.stages;
  const int esz = static_cast<int>(sizeof(Elem));
  const bool vec = (Dh * esz) % 16 == 0 && (p.k_st * esz) % 16 == 0 &&
                   (p.v_st * esz) % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(kb) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(vb) & 15) == 0;
  auto issue = [&](int i) {
    if (i < items) {
      const int t = i < ntiles ? i : i - ntiles;
      load_tile<KV>(ring + (i % stages) * tile * pitch, i < ntiles ? kb : vb,
                    i < ntiles ? p.k_st : p.v_st, rows, t * tile,
                    min(tile, n - t * tile), Dh, nchunk, pitch, lj, lc, dj,
                    dc, vec);
    }
    cp_async_commit();  // empty past the last item: one group per item
  };

  // the first kThreads query values and (codes) the span's scales (one
  // row a thread: span <= kThreads) are loaded first, and stored to
  // shared memory once the prologue's copies are issued
  auto q_at = [&](int i) {
    const int r = i / dq;
    const int d = i - r * dq;
    return d < Dh ? to_f32(q[r * Dh + d]) : 0.f;
  };
  const float q0 = tid < rep * dq ? q_at(tid) : 0.f;
  float ksv = 0.f;
  float vsv = 0.f;
  if constexpr (KV::kScaled) {
    if (tid < n) {
      const long long so = rows(tid) * p.s_st;
      ksv = ksb[so];
      vsv = vsb[so];
    }
  }
  for (int i = 0; i < stages; ++i) issue(i);
  if (tid < rep * dq) q_s[tid] = q0;
  for (int i = tid + kThreads; i < rep * dq; i += kThreads) q_s[i] = q_at(i);
  if constexpr (KV::kScaled) {
    if (tid < n) {
      ks_s[tid] = ksv;
      vs_s[tid] = vsv;
    }
  }

  // score pass: thread (row sj, part sp) of `ds` adjacent lanes per row
  const int ds = kThreads / tile;
  const int sj = tid / ds;
  const int sp = tid - sj * ds;
  // value pass: thread (unit vu, row group vg) of G groups
  const int nu = (Dh + kUnit - 1) / kUnit;
  const int G = max(1, kThreads / nu);
  const bool vact = tid < G * nu;
  const int vg = tid / nu;
  const int vu = tid - vg * nu;
  float acc[kMaxRep][kUnit];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
#pragma unroll
    for (int e = 0; e < kUnit; ++e) acc[r][e] = 0.f;
  }

  for (int i = 0; i < items; ++i) {
    cp_async_wait_at_most(stages - 1);
    __syncthreads();  // item i (and the queries, scales) visible
    const unsigned char* st = ring + (i % stages) * tile * pitch;
    if (i < ntiles) {
      // 1. scores of k tile i: the ds lanes of a row split its chunks,
      // then add their partial dot products by shuffles
      const int r0 = i * tile;
      const int nt = min(tile, n - r0);
      float dot[kMaxRep];
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) dot[r] = 0.f;
      if (sj < nt) {
        const unsigned char* kr = st + sj * pitch;
#pragma unroll 2
        for (int c = sp; c < nchunk; c += ds) {
          float kf[kPer];
          load_f32<KV, kPer>(kr + c * 16, kf);
#pragma unroll
          for (int r = 0; r < kMaxRep; ++r) {
            if (r < rep) {
              const float4* qv =
                  reinterpret_cast<const float4*>(q_s + r * dq + c * kPer);
#pragma unroll
              for (int e = 0; e < kPer / 4; ++e) {
                const float4 x = qv[e];
                dot[r] += x.x * kf[4 * e] + x.y * kf[4 * e + 1] +
                          x.z * kf[4 * e + 2] + x.w * kf[4 * e + 3];
              }
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        if (r < rep) {
          for (int off = ds >> 1; off > 0; off >>= 1)
            dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], off);
          if (sp == 0 && sj < nt) {
            float s = dot[r];
            if constexpr (KV::kScaled) s *= ks_s[r0 + sj];
            sc[r * span + r0 + sj] = s * p.scale;
          }
        }
      }
    } else {
      if (i == ntiles) {
        // 2. softmax over the span, one warp per query: m, l, and the
        // weights (times the row's v scale, for codes) over the scores
        for (int r = warp; r < rep; r += kWarps) {
          float* sr = sc + r * span;
          float mx = kNegInf;
          for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sr[j]);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          float sum = 0.f;
          for (int j = lane; j < n; j += 32) {
            float pj = expf(sr[j] - mx);
            sum += pj;
            if constexpr (KV::kScaled) pj *= vs_s[j];
            sr[j] = pj;
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, off);
          if (lane == 0) {
            m_s[r] = mx;
            l_s[r] = sum;
          }
        }
        __syncthreads();
      }
      // 3. values of v tile i - ntiles, weighted
      const int r0 = (i - ntiles) * tile;
      const int nt = min(tile, n - r0);
      if (vact) {
        const unsigned char* vcol =
            st + vu * kUnit * static_cast<int>(sizeof(Elem));
#pragma unroll 2
        for (int j = vg; j < nt; j += G) {
          float vf[kUnit];
          load_f32<KV, kUnit>(vcol + j * pitch, vf);
#pragma unroll
          for (int r = 0; r < kMaxRep; ++r) {
            if (r < rep) {
              const float w = sc[r * span + r0 + j];
#pragma unroll
              for (int e = 0; e < kUnit; ++e) acc[r][e] += w * vf[e];
            }
          }
        }
      }
    }
    if (i + stages < items) {
      __syncthreads();  // item i's stage is free
      issue(i + stages);
    } else {
      cp_async_commit();
    }
  }
  __syncthreads();  // the ring is idle from here

  // 4. the row groups' accumulators, summed in group order, and m, l
  float* red = reinterpret_cast<float*>(smem);
  const int d4 = nu * kUnit;
  if (vact) {
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r < rep) {
#pragma unroll
        for (int e = 0; e < kUnit; ++e)
          red[(r * G + vg) * d4 + vu * kUnit + e] = acc[r][e];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < rep * Dh; i += kThreads) {
    const int r = i / Dh;
    const int d = i - r * Dh;
    float a = 0.f;
    for (int g = 0; g < G; ++g) a += red[(r * G + g) * d4 + d];
    ws[r * (Dh + 2) + d] = a;
  }
  if (tid < rep) {
    ws[tid * (Dh + 2) + Dh] = m_s[tid];
    ws[tid * (Dh + 2) + Dh + 1] = l_s[tid];
  }
}

template <typename T, typename KV>
__global__ void __launch_bounds__(kThreads, 2)
    ragged_decode_split_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  using Elem = typename KV::Elem;
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int s = blockIdx.z;
  const int len = max(0, min(p.lengths[b], p.rows));
  const int t0 = s * kSpan;
  if (t0 >= len) return;
  const long long qo = ((long long)b * p.Hk + h) * p.rep * p.Dh;
  const long long so = (long long)b * p.s_sb + h;
  float* ws = p.ws + (((long long)b * p.Hk + h) * p.n_split + s) * p.rep *
                         (p.Dh + 2);
  attend_span<T, KV>(
      p, smem, static_cast<const T*>(p.q) + qo,
      static_cast<const Elem*>(p.k) + (long long)b * p.k_sb +
          (long long)h * p.Dh,
      static_cast<const Elem*>(p.v) + (long long)b * p.v_sb +
          (long long)h * p.Dh,
      KV::kScaled ? p.k_scale + so : nullptr,
      KV::kScaled ? p.v_scale + so : nullptr, SlotRows{t0},
      min(kSpan, len - t0), ws);
}

template <typename T, typename KV>
__global__ void __launch_bounds__(kThreads, 2)
    paged_ragged_decode_split_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  using Elem = typename KV::Elem;
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int s = blockIdx.z;
  const int len = max(0, min(p.lengths[b], p.rows));
  const int t0 = s * kSpan;
  if (t0 >= len) return;
  const int n = min(kSpan, len - t0);
  // the physical row of each of this span's rows, through the table
  // entries of its own pages and no more (later entries alias pages of
  // other slots)
  int* phys = reinterpret_cast<int*>(
      smem + layout(p).phys);
  const int* bt = p.table + (long long)b * p.table_sb;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const int t = t0 + j;
    phys[j] = bt[t / p.page] * p.page + t % p.page;
  }
  __syncthreads();
  const long long qo = ((long long)b * p.Hk + h) * p.rep * p.Dh;
  float* ws = p.ws + (((long long)b * p.Hk + h) * p.n_split + s) * p.rep *
                         (p.Dh + 2);
  attend_span<T, KV>(
      p, smem, static_cast<const T*>(p.q) + qo,
      static_cast<const Elem*>(p.k) + (long long)h * p.Dh,
      static_cast<const Elem*>(p.v) + (long long)h * p.Dh,
      KV::kScaled ? p.k_scale + h : nullptr,
      KV::kScaled ? p.v_scale + h : nullptr, PagedRows{phys}, n, ws);
}

// Merge the non-empty spans of slot b, kv head h, in span order; exact
// zeros when there are none. Thread i computes outputs i, i + kThreads,
// ... of the rep x Dh: the largest running max M of its query over the
// spans, then w_s = exp(m_s - M), den = sum_s w_s l_s and acc = sum_s w_s
// acc_s, both in span order, with the loads of 8 spans in flight.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ragged_decode_merge_kernel(const Params p) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int rep = p.rep;
  const int Dh = p.Dh;
  const int len = max(0, min(p.lengths[b], p.rows));
  const int ns = (len + kSpan - 1) / kSpan;
  const int qp = Dh + 2;                          // one query's state
  const long long stride = (long long)rep * qp;   // one span's state
  const float* base = p.ws + ((long long)b * p.Hk + h) * p.n_split * stride;
  T* out = static_cast<T*>(p.out) + ((long long)b * p.Hk + h) * rep * Dh;
  for (int i = threadIdx.x; i < rep * Dh; i += kThreads) {
    const int r = i / Dh;
    const int d = i - r * Dh;
    const float* st = base + r * qp;  // span 0, query r
    float M = kNegInf;
#pragma unroll 8
    for (int s = 0; s < ns; ++s) M = fmaxf(M, st[s * stride + Dh]);
    float den = 0.f;
    float acc = 0.f;
#pragma unroll 8
    for (int s = 0; s < ns; ++s) {
      const float* ss = st + s * stride;
      const float w = expf(ss[Dh] - M);
      den += w * ss[Dh + 1];
      acc += w * ss[d];
    }
    out[i] = from_f32<T>(acc / fmaxf(den, 1e-30f));
  }
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
      f(Tag<T>{}, Tag<F32KV>{});
      return true;
    case kBFloat16:
      f(Tag<T>{}, Tag<BF16KV>{});
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

int kv_size(int kv_dtype) {
  switch (kv_dtype) {
    case kFloat32:
      return 4;
    case kBFloat16:
      return 2;
    case kInt8:
    case kFloat8E4M3:
      return 1;
    default:
      return 0;
  }
}

bool is_code(int kv_dtype) {
  return kv_dtype == kInt8 || kv_dtype == kFloat8E4M3;
}

// Checks the shape, fills in tile, pitch and shared-memory bytes; false
// for a call the kernels do not take.
bool prepare(Params& p, int B, int kv_dtype) {
  const int esz = kv_size(kv_dtype);
  if (esz == 0 || B < 0 || p.Hk < 1 || p.Hk > 65535 || p.rep < 1 ||
      p.rep > kMaxRep || p.Dh < 1 || p.Dh > kMaxDh || p.rows < 0 ||
      p.n_split != (p.rows + kSpan - 1) / kSpan || p.n_split > 65535 ||
      p.page < 1 ||
      (is_code(kv_dtype) && (p.k_scale == nullptr || p.v_scale == nullptr)))
    return false;
  // the largest tile whose ring fits the budget; rows padded so that the
  // score pass's reads (ds < 8 adjacent lanes per row, 8 / ds rows per 8
  // lanes) fall on distinct bank groups: pitch / 16 = ds (mod 8)
  const int rbp = round_up(p.Dh * esz, 16);
  for (p.tile = kMaxTile;; p.tile /= 2) {
    const int ds = kThreads / p.tile;
    const int pad = ds < 8 ? ((ds - (rbp / 16) % 8) % 8 + 8) % 8 : 0;
    p.pitch = rbp + 16 * pad;
    if (p.tile == kMinTile || kMinStages * p.tile * p.pitch <= kRingBudget)
      break;
  }
  // as many stages as the budget holds, but no more than a span's items
  const int items = 2 * ((kSpan + p.tile - 1) / p.tile);
  p.stages = kRingBudget / (p.tile * p.pitch);
  p.stages = p.stages < kMinStages   ? kMinStages
             : p.stages > kMaxStages ? kMaxStages
                                     : p.stages;
  p.stages = p.stages < items ? p.stages : items;
  p.smem = layout(p).total;
  return true;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) allowed = bytes;
  return e;
}

// The split pass (skipped when no row can be read) and the merge.
template <typename T, typename KV, bool kPaged>
int run(const Params& p, int B, cudaStream_t s) {
  static int allowed = 48 * 1024;
  if (p.n_split > 0) {
    const dim3 grid(B, p.Hk, p.n_split);
    if constexpr (kPaged) {
      auto kernel = paged_ragged_decode_split_kernel<T, KV>;
      const cudaError_t e = allow_smem(kernel, p.smem, allowed);
      if (e != cudaSuccess) return (int)e;
      kernel<<<grid, kThreads, p.smem, s>>>(p);
    } else {
      auto kernel = ragged_decode_split_kernel<T, KV>;
      const cudaError_t e = allow_smem(kernel, p.smem, allowed);
      if (e != cudaSuccess) return (int)e;
      kernel<<<grid, kThreads, p.smem, s>>>(p);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  ragged_decode_merge_kernel<T><<<dim3(B, p.Hk), kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

template <bool kPaged>
int dispatch(Params& p, int B, int dtype, int kv_dtype, void* stream) {
  if (!prepare(p, B, kv_dtype)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
  const bool ok = with_types(dtype, kv_dtype, [&](auto qt, auto kvt) {
    using T = typename decltype(qt)::type;
    using KV = typename decltype(kvt)::type;
    err = run<T, KV, kPaged>(p, B, s);
  });
  return ok ? err : (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro_torch

// q (B, Hk, rep, Dh) contiguous, in `dtype` (float32 or bfloat16); k, v
// (B, T, Hk, Dh) in `kv_dtype` (float32, bfloat16, int8 or e4m3 codes)
// with element strides k_sb/v_sb (batch) and k_st/v_st (row), heads and
// features contiguous; with codes, k_scale and v_scale (B, T, Hk) float32
// with element strides s_sb (batch) and s_st (row), heads contiguous (null
// and ignored for float k/v); lengths (B,) int32; ws (B, Hk, n_split, rep,
// Dh + 2) float32 workspace, n_split = ceil(T / kSpan); out (B, Hk, rep,
// Dh) contiguous in `dtype`. Launches the split and
// the merge kernel; returns the CUDA error code of the launches (0 =
// success).
extern "C" int ragged_decode_attention_launch(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* lengths, void* ws, void* out, int B,
    int Hk, int rep, int Dh, int T_rows, int n_split,
    long long k_sb, long long k_st, long long v_sb, long long v_st,
    long long s_sb, long long s_st, float scale, int dtype, int kv_dtype,
    void* stream) {
  using namespace repro_torch;
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.lengths = static_cast<const int*>(lengths);
  p.ws = static_cast<float*>(ws);
  p.out = out;
  p.Hk = Hk;
  p.rep = rep;
  p.Dh = Dh;
  p.rows = T_rows;
  p.n_split = n_split;
  p.page = 1;
  p.k_sb = k_sb;
  p.k_st = k_st;
  p.v_sb = v_sb;
  p.v_st = v_st;
  p.s_sb = s_sb;
  p.s_st = s_st;
  p.scale = scale;
  return dispatch<false>(p, B, dtype, kv_dtype, stream);
}

// q (B, Hk, rep, Dh) contiguous, in `dtype`; k_pool, v_pool (R, Hk, Dh) in
// `kv_dtype` with row strides k_st/v_st in elements, heads and features
// contiguous; with codes, k_scale and v_scale (R, Hk) float32 with row
// stride s_st, heads contiguous (null and ignored for float pools);
// lengths (B,) int32; table (B, npages) int32 with row stride table_sb,
// npages >= ceil(t_max / page); ws (B, Hk, n_split, rep, Dh + 2) float32,
// n_split = ceil(t_max / kSpan); out (B, Hk, rep, Dh) contiguous. Returns
// the CUDA error code of the launches (0 = success).
extern "C" int paged_ragged_decode_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* lengths,
    const void* table, void* ws, void* out, int B, int Hk, int rep, int Dh,
    int t_max, int page, int n_split, long long table_sb,
    long long k_st, long long v_st, long long s_st, float scale, int dtype,
    int kv_dtype, void* stream) {
  using namespace repro_torch;
  Params p{};
  p.q = q;
  p.k = k_pool;
  p.v = v_pool;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.lengths = static_cast<const int*>(lengths);
  p.table = static_cast<const int*>(table);
  p.ws = static_cast<float*>(ws);
  p.out = out;
  p.Hk = Hk;
  p.rep = rep;
  p.Dh = Dh;
  p.rows = t_max;
  p.n_split = n_split;
  p.page = page;
  p.table_sb = table_sb;
  p.k_st = k_st;
  p.v_st = v_st;
  p.s_st = s_st;
  p.scale = scale;
  return dispatch<true>(p, B, dtype, kv_dtype, stream);
}

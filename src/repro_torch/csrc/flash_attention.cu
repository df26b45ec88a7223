// Blocked online-softmax (flash) attention for Hopper: causal and/or
// sliding-window masks, GQA read in place, contiguous or paged k/v, and a
// fused dequant of int8 / float8_e4m3fn k/v codes.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (:120; Pallas body `_fa_kernel`, skip predicate `_block_skipped`) in both
// of its modes:
//   flash_attention_launch        contiguous k/v (B, T, Hk, dh), the mode
//                                 ops.mha_flash reaches;
//   paged_flash_attention_launch  row pools (R, Hk, dh) read through a
//                                 (B, nk) block table (`_fa_paged_kernel`),
//                                 the mode ops.mha_flash_paged reaches.
// For batch row b, query position i < S, query head hq and its kv head
// h = hq / rep, with key positions j < T counted from 0 like i:
//
//   out[b, i, hq] = sum_j softmax_j(q[b, i, hq] . k[b, j, h] * scale)
//                   * v[b, j, h],  over keys j visible to i:
//   visible = (!causal || i >= j) && (window == 0 || i - j < window).
//
// Masked scores are -1e30 and masked probabilities exactly 0, the f32 online
// softmax ends with acc / max(l, 1e-30) (a row that sees no key gives 0),
// and the result is written in q's dtype, as `_fa_kernel` does. With int8 or
// fp8 codes, k and v are code * scale in f32, scales (B, T, Hk) or (R, Hk)
// f32, converted while the kv tile is loaded: the dequantized k/v never
// reach device memory. In the paged mode row t of sequence b lives at pool
// row bt[b, t / page] * page + t % page, T = nk * page, and rows past the
// caller's valid count are attended like any other (causal masks them).
//
// What bounds it on the H100: operations, for any prefill-sized shape. Each
// visible (query, key) pair costs 4 * dh operations (q.k and p.v), against
// bytes of q, k, v, out read or written once: at S = T = 2048, H = 16,
// dh = 128, causal, that is ~7e10 operations (0.07 ms of bf16 tensor-core
// time) against ~0.1 GB (0.03 ms). The kernel cuts both the way the TPU
// kernel does: kv tiles fully masked for the whole query tile (above the
// causal diagonal, or older than the window) are neither loaded nor
// computed, so a causal call does about half a non-causal call's work.
//
// Design, simple first. A block owns 64 query rows of one (batch row, kv
// head): rows are (position, query head) pairs, position-major, covering
// 64 / rep consecutive positions and the `rep` query heads that read kv
// head h, so each kv tile is read from device memory once per kv head and
// used by all of its query heads (no repeat of k/v as in the reference's
// wrapper). q, k and v are read in place through their strides. 4 warps;
// the block walks the kv tiles that are not skipped, in order:
//   1. load the kv tile into shared memory: 8 features per load, each
//      converted (dequant) on the way;
//   2. scores S = Q K^T * scale, masked;
//   3. online softmax per row: running max, rescale, exp, running sum;
//   4. acc = acc * alpha + P V.
// Two compute paths share the loop and the masks:
//   bf16 q (k/v bf16 or codes): tensor cores, mma.sync m16n8k16 with f32
//     accumulation. Each warp owns 16 rows; Q, K and V are bf16 in shared
//     memory (codes dequantized in f32, then rounded to bf16), P is rounded
//     to bf16 for the P V product; scores, softmax and acc stay f32. Tiles
//     of 64 kv rows at dh <= 128, 32 above (acc takes dh / 2 registers a
//     thread: 160 at dh = 320).
//   f32 q (k/v f32 or codes): f32 FMA throughout, no TF32 and no bf16
//     rounding anywhere. A thread owns 4 rows: 4 x 4 scores of a 32-row kv
//     tile and 4 rows x dh / 8 features of acc.
// dh is any multiple of 8 up to 320, compiled for padded widths 64, 128,
// 256 and 320 (pad features are zero in shared memory and add exact zeros).
// Shared memory per block: bf16 27-82 KiB, f32 42-170 KiB.
//
// Paged and contiguous share one templated body behind a row-address
// policy (SlotRows / PagedRows): the same tile partition (the kernel's own
// tile, not the page), the same arithmetic in the same order, so on the
// same rows the paged result is bitwise equal to the contiguous one.

#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kRows = 64;  // query rows (position, head) per block
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;  // (B, S, H, dh) contiguous, in q's dtype
  const void* k;  // contiguous: (B, T, Hk, dh); paged: (R, Hk, dh)
  const void* v;
  const float* k_scale;  // null when k/v are not codes
  const float* v_scale;
  void* out;  // (B, S, H, dh) contiguous, in q's dtype
  int S, H, Hk, rep, dh, T;
  int n_pos;  // positions per block: kRows / rep
  int causal, window;
  float scale;
  int kv_dtype;
  // element strides of batch and row (paged: batch strides are 0)
  long long k_sb, k_st, v_sb, v_st;
  long long ks_sb, ks_st, vs_sb, vs_st;
  const int* table;  // paged only: (B, nk) int32
  long long table_sb;
  int page;
};

// Row index of logical kv row t in a contiguous cache: t itself.
struct SlotRows {
  static __device__ __forceinline__ SlotRows make(const Params&, int) {
    return {};
  }
  __device__ __forceinline__ long long row(int t) const { return t; }
};

// Pool row of logical kv row t of one sequence, through its table row.
struct PagedRows {
  const int* table;
  int page;
  static __device__ __forceinline__ PagedRows make(const Params& p, int b) {
    return {p.table + (long long)b * p.table_sb, p.page};
  }
  __device__ __forceinline__ long long row(int t) const {
    return (long long)__ldg(table + t / page) * page + t % page;
  }
};

__device__ __forceinline__ bool visible(const Params& p, int i, int j) {
  return j < p.T && (!p.causal || i >= j) &&
         (p.window <= 0 || i - j < p.window);
}

// `_block_skipped`: kv rows [k_lo, k_lo + bn) are masked for every query
// position in [q_lo, q_hi].
__device__ __forceinline__ bool tile_skipped(const Params& p, int q_lo,
                                             int q_hi, int k_lo, int bn) {
  return (p.causal && k_lo > q_hi) ||
         (p.window > 0 && q_lo - (k_lo + bn - 1) >= p.window);
}

// 8 consecutive k or v features at element offset `off` of `base`, as
// stored (kv_dtype) or dequantized (code * s in f32), into shared memory.
template <typename SmemT>
__device__ __forceinline__ void load8(SmemT* dst, const void* base,
                                      long long off, int kv_dtype, float s) {
  float f[8];
  if (kv_dtype == kInt8 || kv_dtype == kFloat8E4M3) {
    const uint2 raw =
        *reinterpret_cast<const uint2*>(static_cast<const uint8_t*>(base) +
                                        off);
    const uint8_t* c = reinterpret_cast<const uint8_t*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      f[e] = (kv_dtype == kInt8 ? int8_to_f32(c[e]) : e4m3_to_f32(c[e])) * s;
  } else if constexpr (sizeof(SmemT) == 2) {  // bf16 stored as it is
    *reinterpret_cast<uint4*>(dst) =
        *reinterpret_cast<const uint4*>(static_cast<const bf16*>(base) + off);
    return;
  } else {  // f32 stored as it is
    const float4* src =
        reinterpret_cast<const float4*>(static_cast<const float*>(base) + off);
    reinterpret_cast<float4*>(dst)[0] = src[0];
    reinterpret_cast<float4*>(dst)[1] = src[1];
    return;
  }
  if constexpr (sizeof(SmemT) == 2) {
    uint4 packed;
    uint32_t* w = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
      w[e] = *reinterpret_cast<const uint32_t*>(&h2);
    }
    *reinterpret_cast<uint4*>(dst) = packed;
  } else {
    reinterpret_cast<float4*>(dst)[0] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
}

// What a block works on: its query positions and its rows' bases.
struct Tile {
  int b, h, p0, n_rows, q_hi;
  long long k_base, v_base, ks_base, vs_base;
};

__device__ __forceinline__ Tile block_tile(const Params& p) {
  Tile w;
  // the heaviest causal tiles (the last positions) are scheduled first
  const int qt = gridDim.x - 1 - blockIdx.x;
  w.h = blockIdx.y;
  w.b = blockIdx.z;
  w.p0 = qt * p.n_pos;
  const int n_pos = min(p.n_pos, p.S - w.p0);
  w.n_rows = n_pos * p.rep;
  w.q_hi = w.p0 + n_pos - 1;
  w.k_base = w.b * p.k_sb + (long long)w.h * p.dh;
  w.v_base = w.b * p.v_sb + (long long)w.h * p.dh;
  w.ks_base = w.b * p.ks_sb + w.h;
  w.vs_base = w.b * p.vs_sb + w.h;
  return w;
}

// Element offset in q / out of block row r (position p0 + r / rep, query
// head h * rep + r % rep).
__device__ __forceinline__ long long row_offset(const Params& p,
                                                const Tile& w, int r) {
  return (((long long)w.b * p.S + w.p0 + r / p.rep) * p.H + w.h * p.rep +
          r % p.rep) *
         (long long)p.dh;
}

// Zero `bytes` of shared memory, then stage the block's query rows (8
// features per load, as stored: q's dtype is the shared-memory type).
template <typename SmemT>
__device__ __forceinline__ void stage_q(const Params& p, const Tile& w,
                                        unsigned char* smem, int bytes,
                                        SmemT* q_s, int qs) {
  for (int i = threadIdx.x; i < bytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  const int nvec = p.dh / 8;
  const int kv_as_stored = sizeof(SmemT) == 2 ? kBFloat16 : kFloat32;
  for (int idx = threadIdx.x; idx < w.n_rows * nvec; idx += kThreads) {
    const int r = idx / nvec, c = idx - r * nvec;
    load8(q_s + r * qs + c * 8, p.q, row_offset(p, w, r) + c * 8,
          kv_as_stored, 1.f);
  }
}

// Stage kv rows [k0, k0 + bn) into k_s / v_s (row strides ks), zeros past T.
template <typename SmemT, typename Rows>
__device__ __forceinline__ void stage_kv(const Params& p, const Tile& w,
                                         const Rows& rows, int k0, int bn,
                                         SmemT* k_s, SmemT* v_s, int ks) {
  const int nvec = p.dh / 8;
  for (int idx = threadIdx.x; idx < bn * nvec; idx += kThreads) {
    const int jr = idx / nvec, c = idx - jr * nvec;
    const int t = k0 + jr;
    SmemT* kd = k_s + jr * ks + c * 8;
    SmemT* vd = v_s + jr * ks + c * 8;
    if (t < p.T) {
      const long long r = rows.row(t);
      float k_sc = 1.f, v_sc = 1.f;
      if (p.k_scale != nullptr) {
        k_sc = __ldg(p.k_scale + w.ks_base + r * p.ks_st);
        v_sc = __ldg(p.v_scale + w.vs_base + r * p.vs_st);
      }
      load8(kd, p.k, w.k_base + r * p.k_st + c * 8, p.kv_dtype, k_sc);
      load8(vd, p.v, w.v_base + r * p.v_st + c * 8, p.kv_dtype, v_sc);
    } else {
#pragma unroll
      for (int e = 0; e < 8 * (int)sizeof(SmemT) / 16; ++e) {
        reinterpret_cast<uint4*>(kd)[e] = make_uint4(0, 0, 0, 0);
        reinterpret_cast<uint4*>(vd)[e] = make_uint4(0, 0, 0, 0);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 queries: tensor cores (mma.sync m16n8k16, f32 accumulation)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices, transposed: the B fragments of two n8 tiles.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h2);
}

template <int DHP>
struct TcShape {
  static constexpr int BN = DHP <= 128 ? 64 : 32;  // kv rows per tile
  static constexpr int LD = DHP + 8;  // smem row stride: no bank conflicts
  static constexpr int kSmem = (kRows + 2 * BN) * LD * 2;
};

template <int DHP, typename Rows>
__global__ void __launch_bounds__(kThreads, DHP <= 128 ? 2 : 1)
    flash_tc_kernel(const Params p) {
  using Sh = TcShape<DHP>;
  constexpr int BN = Sh::BN, LD = Sh::LD;
  constexpr int NF = BN / 8;   // score n8 tiles
  constexpr int OF = DHP / 8;  // output n8 tiles
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + kRows * LD;
  bf16* v_s = k_s + BN * LD;

  const Tile w = block_tile(p);
  const Rows rows = Rows::make(p, w.b);
  stage_q(p, w, smem, Sh::kSmem, q_s, LD);

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16 + g, r1 = r0 + 8;
  const int pos0 = w.p0 + r0 / p.rep, pos1 = w.p0 + r1 / p.rep;
  float o[OF][4];
#pragma unroll
  for (int f = 0; f < OF; ++f) o[f][0] = o[f][1] = o[f][2] = o[f][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  const int nkt = (p.T + BN - 1) / BN;
  for (int j = 0; j < nkt; ++j) {
    const int k0 = j * BN;
    if (tile_skipped(p, w.p0, w.q_hi, k0, BN)) continue;
    __syncthreads();  // the previous tile's reads (and stage_q) are done
    stage_kv(p, w, rows, k0, BN, k_s, v_s, LD);
    __syncthreads();

    // 2. scores of this warp's 16 rows against the tile's BN rows
    float s[NF][4];
#pragma unroll
    for (int f = 0; f < NF; ++f) s[f][0] = s[f][1] = s[f][2] = s[f][3] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < DHP / 16; ++kk) {
      const int c = kk * 16 + 2 * t4;
      const uint32_t a[4] = {ld32(q_s + r0 * LD + c), ld32(q_s + r1 * LD + c),
                             ld32(q_s + r0 * LD + c + 8),
                             ld32(q_s + r1 * LD + c + 8)};
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const bf16* kr = k_s + (f * 8 + g) * LD + c;
        mma_bf16(s[f], a, ld32(kr), ld32(kr + 8));
      }
    }

    // 3. mask, scale and the online softmax of rows r0 (c0, c1) and r1
    uint32_t vis = 0;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = k0 + f * 8 + 2 * t4 + e;
        const bool v0 = visible(p, pos0, t), v1 = visible(p, pos1, t);
        s[f][e] = v0 ? s[f][e] * p.scale : kNegInf;
        s[f][2 + e] = v1 ? s[f][2 + e] * p.scale : kNegInf;
        vis |= (v0 ? 1u : 0u) << (4 * f + e);
        vis |= (v1 ? 1u : 0u) << (4 * f + 2 + e);
        mx0 = fmaxf(mx0, s[f][e]);
        mx1 = fmaxf(mx1, s[f][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[f][e] = (vis >> (4 * f + e)) & 1u ? expf(s[f][e] - mn0) : 0.f;
        s[f][2 + e] =
            (vis >> (4 * f + 2 + e)) & 1u ? expf(s[f][2 + e] - mn1) : 0.f;
        sum0 += s[f][e];
        sum1 += s[f][2 + e];
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    l0 = al0 * l0 + sum0;
    l1 = al1 * l1 + sum1;
    m0 = mn0;
    m1 = mn1;

    // 4. acc = acc * alpha + P V, P rounded to bf16
#pragma unroll
    for (int f = 0; f < OF; ++f) {
      o[f][0] *= al0;
      o[f][1] *= al0;
      o[f][2] *= al1;
      o[f][3] *= al1;
    }
#pragma unroll
    for (int c = 0; c < BN / 16; ++c) {
      const uint32_t a[4] = {pack_bf16(s[2 * c][0], s[2 * c][1]),
                             pack_bf16(s[2 * c][2], s[2 * c][3]),
                             pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]),
                             pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
      const bf16* vr = v_s + (c * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
      for (int f = 0; f < OF; f += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vr + f * 8);
        mma_bf16(o[f], a, b[0], b[1]);
        mma_bf16(o[f + 1], a, b[2], b[3]);
      }
    }
  }

  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  bf16* out = static_cast<bf16*>(p.out);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0;
    if (r >= w.n_rows) continue;
    const float d = half ? d1 : d0;
    bf16* orow = out + row_offset(p, w, r);
#pragma unroll
    for (int f = 0; f < OF; ++f) {
      const int c = f * 8 + 2 * t4;
      if (f * 8 < p.dh) {
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(
            o[f][2 * half] / d, o[f][2 * half + 1] / d);
        *reinterpret_cast<__nv_bfloat162*>(orow + c) = h2;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32 queries: f32 FMA throughout
// ---------------------------------------------------------------------------

template <int DHP>
struct F32Shape {
  static constexpr int BN = 32;       // kv rows per tile
  static constexpr int LD = DHP + 4;  // q, k, v row stride (float4-aligned)
  static constexpr int PL = BN + 1;   // probability row stride
  static constexpr int kSmem = ((kRows + 2 * BN) * LD + kRows * PL) * 4;
};

template <int DHP, typename Rows>
__global__ void __launch_bounds__(kThreads, DHP <= 128 ? 2 : 1)
    flash_f32_kernel(const Params p) {
  using Sh = F32Shape<DHP>;
  constexpr int BN = Sh::BN, LD = Sh::LD, PL = Sh::PL;
  constexpr int OC = DHP / 32;  // float4 column groups a thread owns
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* k_s = q_s + kRows * LD;
  float* v_s = k_s + BN * LD;
  float* p_s = v_s + BN * LD;

  const Tile w = block_tile(p);
  const Rows rows = Rows::make(p, w.b);
  stage_q(p, w, smem, Sh::kSmem, q_s, LD);

  // thread (ty, tx): rows 4ty..4ty+3; score columns tx + 8cc; acc columns
  // 4tx + 32c + e
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  int pos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) pos[i] = w.p0 + (4 * ty + i) / p.rep;
  float o[4][OC * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < OC * 4; ++c) o[i][c] = 0.f;
  }
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }

  const int nkt = (p.T + BN - 1) / BN;
  for (int j = 0; j < nkt; ++j) {
    const int k0 = j * BN;
    if (tile_skipped(p, w.p0, w.q_hi, k0, BN)) continue;
    __syncthreads();  // the previous tile's reads (and stage_q) are done
    stage_kv(p, w, rows, k0, BN, k_s, v_s, LD);
    __syncthreads();

    // 2. scores: 4 rows x 4 kv rows a thread
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) s[i][cc] = 0.f;
    }
#pragma unroll 2
    for (int d = 0; d < p.dh; d += 4) {
      float4 kv[4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        kv[cc] = *reinterpret_cast<const float4*>(k_s + (tx + 8 * cc) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(q_s + (4 * ty + i) * LD + d);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          s[i][cc] = fmaf(qv.x, kv[cc].x, s[i][cc]);
          s[i][cc] = fmaf(qv.y, kv[cc].y, s[i][cc]);
          s[i][cc] = fmaf(qv.z, kv[cc].z, s[i][cc]);
          s[i][cc] = fmaf(qv.w, kv[cc].w, s[i][cc]);
        }
      }
    }

    // 3. mask, scale, online softmax; the 8 threads of a row hold its 32
    // scores and reduce them with shuffles within their group of 8 lanes
    float al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool vis[4];
      float mx = kNegInf;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        vis[cc] = visible(p, pos[i], k0 + tx + 8 * cc);
        s[i][cc] = vis[cc] ? s[i][cc] * p.scale : kNegInf;
        mx = fmaxf(mx, s[i][cc]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      al[i] = expf(m[i] - mn);
      float sum = 0.f;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float pr = vis[cc] ? expf(s[i][cc] - mn) : 0.f;
        p_s[(4 * ty + i) * PL + tx + 8 * cc] = pr;
        sum += pr;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = al[i] * l[i] + sum;
      m[i] = mn;
    }
    __syncthreads();  // p_s is complete

    // 4. acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < OC * 4; ++c) o[i][c] *= al[i];
    }
#pragma unroll 2
    for (int jr = 0; jr < BN; ++jr) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = p_s[(4 * ty + i) * PL + jr];
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        const float4 vv =
            *reinterpret_cast<const float4*>(v_s + jr * LD + 4 * tx + 32 * c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o[i][4 * c] = fmaf(pr[i], vv.x, o[i][4 * c]);
          o[i][4 * c + 1] = fmaf(pr[i], vv.y, o[i][4 * c + 1]);
          o[i][4 * c + 2] = fmaf(pr[i], vv.z, o[i][4 * c + 2]);
          o[i][4 * c + 3] = fmaf(pr[i], vv.w, o[i][4 * c + 3]);
        }
      }
    }
  }

  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= w.n_rows) continue;
    const float d = fmaxf(l[i], 1e-30f);
    float* orow = out + row_offset(p, w, r);
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int col = 4 * tx + 32 * c;
      if (col < p.dh)
        *reinterpret_cast<float4*>(orow + col) =
            make_float4(o[i][4 * c] / d, o[i][4 * c + 1] / d,
                        o[i][4 * c + 2] / d, o[i][4 * c + 3] / d);
    }
  }
}

// ---------------------------------------------------------------------------
// dispatch
// ---------------------------------------------------------------------------

template <typename Kernel>
int run(Kernel kernel, int smem_bytes, dim3 grid, const Params& p,
        cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, smem_bytes, s>>>(p);
  return (int)cudaGetLastError();
}

template <int DHP, typename Rows>
int launch_dh(const Params& p, int q_dtype, dim3 grid, cudaStream_t s) {
  if (q_dtype == kBFloat16)
    return run(flash_tc_kernel<DHP, Rows>, TcShape<DHP>::kSmem, grid, p, s);
  return run(flash_f32_kernel<DHP, Rows>, F32Shape<DHP>::kSmem, grid, p, s);
}

template <typename Rows>
int launch(Params p, int B, int q_dtype, cudaStream_t s) {
  // q bf16: k/v bf16 or codes; q f32: k/v f32 or codes
  const bool codes = p.kv_dtype == kInt8 || p.kv_dtype == kFloat8E4M3;
  if (B < 0 || p.S < 0 || p.Hk < 1 || p.Hk > 65535 || B > 65535 ||
      p.H % p.Hk != 0 || p.dh < 8 || p.dh > 320 || p.dh % 8 != 0 ||
      p.T < 0 || (q_dtype != kBFloat16 && q_dtype != kFloat32) ||
      (!codes && p.kv_dtype != q_dtype) ||
      (codes != (p.k_scale != nullptr && p.v_scale != nullptr)))
    return (int)cudaErrorInvalidValue;
  p.rep = p.H / p.Hk;
  if (p.rep > kRows) return (int)cudaErrorInvalidValue;
  p.n_pos = kRows / p.rep;
  if (B == 0 || p.S == 0) return 0;
  const dim3 grid((p.S + p.n_pos - 1) / p.n_pos, p.Hk, B);
  if (p.dh <= 64) return launch_dh<64, Rows>(p, q_dtype, grid, s);
  if (p.dh <= 128) return launch_dh<128, Rows>(p, q_dtype, grid, s);
  if (p.dh <= 256) return launch_dh<256, Rows>(p, q_dtype, grid, s);
  return launch_dh<320, Rows>(p, q_dtype, grid, s);
}

}  // namespace
}  // namespace repro_torch

// q, out (B, S, H, dh) contiguous in `q_dtype` (0 = float32, 1 = bfloat16);
// k, v (B, T, Hk, dh) in `kv_dtype` (q's, or 2 = int8 / 3 = float8_e4m3fn
// codes) with element strides k_sb/v_sb (batch) and k_st/v_st (row), heads
// and features contiguous, 16-byte aligned rows; k_scale, v_scale (B, T, Hk)
// float32 with strides ks_sb/vs_sb and ks_st/vs_st, heads contiguous, for
// codes, else null. causal 0/1, window 0 = none. Returns the CUDA error code
// of the launch (0 = success).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, void* out, int B, int S, int H, int Hk, int dh,
    int T, long long k_sb, long long k_st, long long v_sb, long long v_st,
    long long ks_sb, long long ks_st, long long vs_sb, long long vs_st,
    int causal, int window, float scale, int q_dtype, int kv_dtype,
    void* stream) {
  using namespace repro_torch;
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.out = out;
  p.S = S;
  p.H = H;
  p.Hk = Hk;
  p.dh = dh;
  p.T = T;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.kv_dtype = kv_dtype;
  p.k_sb = k_sb;
  p.k_st = k_st;
  p.v_sb = v_sb;
  p.v_st = v_st;
  p.ks_sb = ks_sb;
  p.ks_st = ks_st;
  p.vs_sb = vs_sb;
  p.vs_st = vs_st;
  return launch<SlotRows>(p, B, q_dtype, static_cast<cudaStream_t>(stream));
}

// As flash_attention_launch, but k, v are (R, Hk, dh) row pools with row
// strides k_st/v_st, read through `table` (B, nk) int32 with row stride
// table_sb: logical row t of sequence b is pool row
// table[b, t / page] * page + t % page, for t < T = nk * page. Scales are
// (R, Hk) float32 with row strides ks_st/vs_st. Needs causal or window > 0
// (the reference's rule). Returns the CUDA error code of the launch.
extern "C" int paged_flash_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* table, void* out,
    int B, int S, int H, int Hk, int dh, int nk, int page,
    long long table_sb, long long k_st, long long v_st, long long ks_st,
    long long vs_st, int causal, int window, float scale, int q_dtype,
    int kv_dtype, void* stream) {
  using namespace repro_torch;
  if (page < 1 || nk < 0 || (long long)nk * page > 0x7fffffffLL ||
      !(causal || window > 0))
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.q = q;
  p.k = k_pool;
  p.v = v_pool;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.out = out;
  p.S = S;
  p.H = H;
  p.Hk = Hk;
  p.dh = dh;
  p.T = nk * page;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.kv_dtype = kv_dtype;
  p.k_st = k_st;
  p.v_st = v_st;
  p.ks_st = ks_st;
  p.vs_st = vs_st;
  p.table = static_cast<const int*>(table);
  p.table_sb = table_sb;
  p.page = page;
  return launch<PagedRows>(p, B, q_dtype, static_cast<cudaStream_t>(stream));
}

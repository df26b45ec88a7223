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
// Masked probabilities are exactly 0, the f32 online softmax ends with
// acc / max(l, 1e-30) (a row that sees no key gives 0), and the result is
// written in q's dtype, as `_fa_kernel` does. With int8 or fp8 codes, k and
// v are code * scale, scales (B, T, Hk) or (R, Hk) f32; the dequantized k/v
// never reach device memory. In the paged mode row t of sequence b lives at
// pool row bt[b, t / page] * page + t % page, T = nk * page, and rows past
// the caller's valid count are attended like any other (causal masks them).
//
// What bounds it on the H100: operations, for any prefill-sized shape. Each
// visible (query, key) pair costs 4 * dh operations (q.k and p.v), against
// bytes of q, k, v, out read or written once: at S = T = 2048, H = 16,
// dh = 128, causal, that is ~7e10 operations (0.07 ms of bf16 tensor-core
// time) against ~0.1 GB (0.03 ms). Kv tiles fully masked for the whole
// query tile (above the causal diagonal, or older than the window) are
// neither loaded nor computed, as in the TPU kernel, so a causal call does
// about half a non-causal call's work.
//
// bf16 q (k/v bf16 or codes): warp-specialised, for the tensor cores. A
// block owns 128 query rows of one (batch row, kv head): rows are
// (position, query head) pairs, position-major, covering 128 / rep
// consecutive positions and the `rep` query heads that read kv head h, so
// each kv tile is read once per kv head. 3 warpgroups of 128 threads:
//   producer (warpgroup 2, 40 registers by setmaxnreg): loads q once by
//     TMA, then fills a ring of k/v stages in shared memory (3 where they
//     fit, else 2), each guarded by a `full` and an `empty` mbarrier. Two
//     producers, chosen on the host from the shapes alone:
//       TmaProducer     its first warp issues TMA tensor loads
//                       (cp.async.bulk.tensor) of 64-column boxes: bf16
//                       k/v straight into the 128-byte swizzled stage that
//                       wgmma reads; codes into a staging ring (2 buffers,
//                       1 at dh 256) that the warpgroup converts to bf16.
//                       Contiguous k/v are a 4-D map (dh, Hk, T, B) whose
//                       out-of-bounds rows and features read as zeros; a
//                       pool is a 3-D map (dh, Hk, R), one box per page,
//                       each page looked up and loaded by its own lane.
//       CpAsyncProducer the warpgroup copies 16-byte (bf16) or 8-byte
//                       (code) chunks with cp.async, zero-filling rows past
//                       T and features past dh: for what a tensor map
//                       cannot describe (code rows or strides that are not
//                       16-byte multiples, pages that are not a multiple
//                       of 8 rows or that neither divide nor are a multiple
//                       of the kv tile, T = 0).
//   consumers (warpgroups 0 and 1, 64 rows each, 232 registers): per kv
//     tile, S = Q K^T by wgmma (bf16 from shared memory, f32 accumulators);
//     the online softmax in the exp2 domain: scores times scale * log2(e)
//     (folded into the exponent's FFMA on interior bf16 tiles; times each
//     column's k scale for codes), the mask only on tiles that straddle the
//     causal diagonal, the window edge or T; P (times each column's v scale
//     for codes) rounded to bf16 and kept in registers as wgmma's A
//     operand; acc = acc * alpha + P V by wgmma (V read MN-major from the
//     swizzled stage). Each consumer issues tile j's Q K^T ahead of tile
//     j - 1's P V, so its softmax of tile j runs while that P V is on the
//     tensor cores, and the two consumers take turns (named barriers) to
//     issue, so one's softmax runs while the other's products do. A
//     consumer skips the tiles fully masked for its own 64 rows.
// Codes convert exactly to bf16 (int8 and e4m3 both fit); their scales are
// applied in f32 to score and probability columns, so code * scale is never
// rounded to bf16. Kv tiles: 128 rows at dh <= 128 (96 for codes at dh
// 128, so that 3 stages fit beside the staging ring), 64 at dh <= 256, 32
// at dh 320 (acc takes dh / 2 registers a thread). dh is any multiple of 8
// up to 320, compiled for padded widths 64, 128, 256 and 320; only the
// 64-column blocks that hold features are loaded, the others stay zero.
// Shared memory per block: 112-227 KiB.
//
// f32 q (k/v f32 or codes): f32 FMA throughout, no TF32 and no bf16
// rounding anywhere, 128 threads for 64 rows; a thread owns 4 rows: 4 x 4
// scores of a 32-row kv tile and 4 rows x dh / 8 features of acc.
//
// Paged and contiguous share each body behind a row-address policy
// (SlotRows / PagedRows): the same tile partition (the kernel's own tile,
// not the page), the same arithmetic in the same order whichever producer
// loads the tile, so on the same rows the paged result is bitwise equal to
// the contiguous one.

#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda link)
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include <cuda_fp16.h>

#include "common.cuh"
#include "hopper.cuh"

namespace repro_torch {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // f32 path
constexpr int kRows = 64;      // f32 path: query rows (position, head)
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;  // (B, S, H, dh) contiguous, in q's dtype
  const void* k;  // contiguous: (B, T, Hk, dh); paged: (R, Hk, dh)
  const void* v;
  const float* k_scale;  // null when k/v are not codes
  const float* v_scale;
  void* out;  // (B, S, H, dh) contiguous, in q's dtype
  int S, H, Hk, rep, dh, T;
  int n_pos;  // positions per block: rows per block / rep
  int causal, window;
  float scale;
  int kv_dtype;
  // element strides of batch and row (paged: batch strides are 0)
  long long k_sb, k_st, v_sb, v_st;
  long long ks_sb, ks_st, vs_sb, vs_st;
  const int* table;  // paged only: (B, nk) int32
  long long table_sb;
  int page;
  int R;  // paged only: pool rows
};

// Row index of logical kv row t in a contiguous cache: t itself.
struct SlotRows {
  static constexpr bool kPaged = false;
  static __device__ __forceinline__ SlotRows make(const Params&, int) {
    return {};
  }
  __device__ __forceinline__ long long row(int t) const { return t; }
};

// Pool row of logical kv row t of one sequence, through its table row.
struct PagedRows {
  static constexpr bool kPaged = true;
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
__device__ __forceinline__ void load8(float* dst, const void* base,
                                      long long off, int kv_dtype, float s) {
  if (kv_dtype == kInt8 || kv_dtype == kFloat8E4M3) {
    const uint2 raw =
        *reinterpret_cast<const uint2*>(static_cast<const uint8_t*>(base) +
                                        off);
    const uint8_t* c = reinterpret_cast<const uint8_t*>(&raw);
    float f[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      f[e] = (kv_dtype == kInt8 ? int8_to_f32(c[e]) : e4m3_to_f32(c[e])) * s;
    reinterpret_cast<float4*>(dst)[0] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(f[4], f[5], f[6], f[7]);
    return;
  }
  const float4* src =
      reinterpret_cast<const float4*>(static_cast<const float*>(base) + off);
  reinterpret_cast<float4*>(dst)[0] = src[0];
  reinterpret_cast<float4*>(dst)[1] = src[1];
}

// What a block works on: its query positions and its rows' bases.
struct Tile {
  int b, h, p0, n_rows, q_hi;
  long long k_base, v_base, ks_base, vs_base;
};

// Query tile qt (positions qt * n_pos ...) of kv head h of batch row b.
__device__ __forceinline__ Tile block_tile(const Params& p, int qt, int h,
                                           int b) {
  Tile w;
  w.h = h;
  w.b = b;
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

// The kv tiles a block loads, [j_lo, j_lo + n): `tile_skipped` masks a
// prefix (older than the window) and a suffix (above the diagonal), so
// the tiles it keeps are one contiguous range.
__device__ __forceinline__ void tile_range(const Params& p, const Tile& w,
                                           int bn, int& j_lo, int& n) {
  int j_hi = (p.T + bn - 1) / bn - 1;
  if (p.causal) j_hi = min(j_hi, w.q_hi / bn);
  j_lo = 0;
  if (p.window > 0) {
    const int first = w.p0 - p.window + 1;  // oldest key any row sees
    if (first > 0) j_lo = first / bn;
  }
  n = max(0, j_hi - j_lo + 1);
}

// ---------------------------------------------------------------------------
// bf16 queries: TMA / cp.async producer warpgroup, wgmma consumers
// ---------------------------------------------------------------------------

// Shared-memory layout of one block. Every tile is bf16 in 64-column
// blocks of BN (or ROWS) rows x 128 bytes, 128-byte swizzled, 1024-byte
// aligned; codes stage unswizzled, 64 bytes a row.
template <int DHP, bool CODES>
struct WgShape {
  static constexpr int NWG = 2;  // consumer warpgroups, 64 rows each
  static constexpr int ROWS = 64 * NWG;
  static constexpr int THREADS = 128 * (NWG + 1);
  // kv rows a tile; codes at dh 128 take 96, so that 3 stages fit beside
  // their staging buffers
  static constexpr int BN =
      DHP <= 128 ? (CODES && DHP == 128 ? 96 : 128) : (DHP <= 256 ? 64 : 32);
  static constexpr int CS = CODES ? (DHP == 256 ? 1 : 2) : 0;  // code ring
  static constexpr int kTile = BN * DHP * 2;  // k or v of one stage
  static constexpr int kCode = BN * DHP;  // k or v codes of one buffer
  static constexpr int bytes(int st) {
    return ROWS * DHP * 2 + st * 2 * kTile + CS * 2 * kCode +
           (CODES ? st * 2 * BN * 4 : 0) + 8 * (2 * st + CS + 1);
  }
  static constexpr int ST = bytes(3) <= 232448 ? 3 : 2;  // k/v ring stages
  static constexpr int kQ = 0;
  static constexpr int kKV = kQ + ROWS * DHP * 2;
  static constexpr int kCodes = kKV + ST * 2 * kTile;
  static constexpr int kScales = kCodes + CS * 2 * kCode;
  static constexpr int kBars = kScales + (CODES ? ST * 2 * BN * 4 : 0);
  static constexpr int kSmem = kBars + 8 * (2 * ST + CS + 1);
  static_assert(kSmem == bytes(ST) && kSmem <= 232448, "one block's smem");
};

template <int DHP, bool CODES>
struct WgSmem {
  using Sh = WgShape<DHP, CODES>;
  unsigned char* base;
  __device__ __forceinline__ bf16* q() const {
    return reinterpret_cast<bf16*>(base + Sh::kQ);
  }
  __device__ __forceinline__ unsigned char* k(int s) const {
    return base + Sh::kKV + 2 * s * Sh::kTile;
  }
  __device__ __forceinline__ unsigned char* v(int s) const {
    return k(s) + Sh::kTile;
  }
  __device__ __forceinline__ unsigned char* kc(int c) const {
    return base + Sh::kCodes + 2 * c * Sh::kCode;
  }
  __device__ __forceinline__ unsigned char* vc(int c) const {
    return kc(c) + Sh::kCode;
  }
  // k scales times scale * log2(e), and v scales, of stage s
  __device__ __forceinline__ float* ks(int s) const {
    return reinterpret_cast<float*>(base + Sh::kScales) + 2 * s * Sh::BN;
  }
  __device__ __forceinline__ float* vs(int s) const {
    return ks(s) + Sh::BN;
  }
  __device__ __forceinline__ uint64_t* bars() const {
    return reinterpret_cast<uint64_t*>(base + Sh::kBars);
  }
  __device__ __forceinline__ uint64_t* full(int s) const { return bars() + s; }
  __device__ __forceinline__ uint64_t* empty(int s) const {
    return bars() + Sh::ST + s;
  }
  __device__ __forceinline__ uint64_t* code_full(int c) const {
    return bars() + 2 * Sh::ST + c;
  }
  __device__ __forceinline__ uint64_t* q_full() const {
    return bars() + 2 * Sh::ST + Sh::CS;
  }
};

// The tensor maps of one call (kernel parameters: __grid_constant__).
struct Maps {
  CUtensorMap q;  // (dh, H, S, B) bf16, box (64, rep, n_pos, 1)
  CUtensorMap k;  // (dh, Hk, T, B) or (dh, Hk, R): box (64, 1, rows[, 1])
  CUtensorMap v;
  CUtensorMap out;  // as q
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h2);
}

// Byte offset in a swizzled 64-column block of the 16-byte chunk q of row
// r (rows of 128 bytes).
__device__ __forceinline__ int swz(int r, int q) {
  return r * 128 + ((q ^ (r & 7)) << 4);
}

// 4 codes (one word, code i in byte i) as 4 bf16 (two words, code i in
// half i), exactly: every int8 and every e4m3 value is a bf16 value.
// int8 by integer arithmetic (the byte + 128 under 2^23, minus 2^23 + 128),
// e4m3 through the hardware's e4m3x2 -> f16x2 conversion.
__device__ __forceinline__ uint2 codes4_to_bf16(uint32_t w, int kv_dtype) {
  float f[4];
  if (kv_dtype == kInt8) {
    const uint32_t u = w ^ 0x80808080u;  // byte i is code i + 128
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) -
             8388736.f;
  } else {
    uint32_t h01, h23;
    asm("{\n.reg .b16 lo, hi;\nmov.b32 {lo, hi}, %2;\n"
        "cvt.rn.f16x2.e4m3x2 %0, lo;\ncvt.rn.f16x2.e4m3x2 %1, hi;\n}\n"
        : "=r"(h01), "=r"(h23)
        : "r"(w));
    const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&h01));
    const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&h23));
    f[0] = a.x;
    f[1] = a.y;
    f[2] = b.x;
    f[3] = b.y;
  }
  return make_uint2(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]));
}

__device__ __forceinline__ uint4 codes_to_bf16(uint2 raw, int kv_dtype) {
  const uint2 lo = codes4_to_bf16(raw.x, kv_dtype);
  const uint2 hi = codes4_to_bf16(raw.y, kv_dtype);
  return make_uint4(lo.x, lo.y, hi.x, hi.y);
}

// Converts code unit `idx` (8 codes: 64-column block c, row r, chunk q) of
// the staged k and v codes into the bf16 stage; rows >= valid read zero.
template <int DHP, bool CODES>
__device__ __forceinline__ void convert_unit(const WgSmem<DHP, CODES>& sm,
                                             int cbuf, int stage, int idx,
                                             int valid, int kv_dtype) {
  constexpr int BN = WgShape<DHP, CODES>::BN;
  const int c = idx / (BN * 8), rem = idx - c * BN * 8;
  const int r = rem >> 3, q = rem & 7;
  uint4 kb = make_uint4(0, 0, 0, 0), vb = kb;
  if (r < valid) {
    const int off = c * BN * 64 + r * 64 + q * 8;
    kb = codes_to_bf16(*reinterpret_cast<const uint2*>(sm.kc(cbuf) + off),
                       kv_dtype);
    vb = codes_to_bf16(*reinterpret_cast<const uint2*>(sm.vc(cbuf) + off),
                       kv_dtype);
  }
  const int dst = c * BN * 128 + swz(r, q);
  *reinterpret_cast<uint4*>(sm.k(stage) + dst) = kb;
  *reinterpret_cast<uint4*>(sm.v(stage) + dst) = vb;
}

// What a bf16 block works on: its query tile (the heaviest causal tiles,
// the last positions, are scheduled first) and its kv tiles.
struct WgBlock {
  Tile w;
  int j_lo, n_tiles, n_ch;  // kv tiles; live 64-column blocks of dh
};

__device__ __forceinline__ WgBlock wg_block(const Params& p, int bn) {
  WgBlock bk;
  bk.w = block_tile(p, gridDim.x - 1 - blockIdx.x, blockIdx.y, blockIdx.z);
  tile_range(p, bk.w, bn, bk.j_lo, bk.n_tiles);
  bk.n_ch = (p.dh + 63) / 64;
  return bk;
}

// The scales of row i < BN of kv tile k0 (0 past T), k's times
// scale * log2(e), into stage s.
template <int DHP, bool CODES, typename Rows>
__device__ __forceinline__ void store_scales(const Params& p,
                                             const WgBlock& bk,
                                             const Rows& rows,
                                             const WgSmem<DHP, CODES>& sm,
                                             int s, int k0, int i) {
  if constexpr (CODES) {
    if (i < WgShape<DHP, CODES>::BN) {
      float ksv = 0.f, vsv = 0.f;
      if (k0 + i < p.T) {
        const long long r = rows.row(k0 + i);
        ksv = __ldg(p.k_scale + bk.w.ks_base + r * p.ks_st) *
              (p.scale * kLog2e);
        vsv = __ldg(p.v_scale + bk.w.vs_base + r * p.vs_st);
      }
      sm.ks(s)[i] = ksv;
      sm.vs(s)[i] = vsv;
    }
  }
}

__device__ __forceinline__ void load_q(const Params& p, const Maps& maps,
                                       const WgBlock& bk, bf16* q_s,
                                       uint64_t* bar, int rows_alloc) {
  const uint32_t box = 64 * p.rep * p.n_pos * 2;
  mbar_arrive_expect_tx(bar, box * bk.n_ch);
  for (int c = 0; c < bk.n_ch; ++c)
    tma_load_4d(reinterpret_cast<unsigned char*>(q_s) + c * rows_alloc * 128,
                &maps.q, bar, c * 64, bk.w.h * p.rep, bk.w.p0, bk.w.b);
}

// TMA producer: tensor loads of whole boxes, issued by the first warp.
struct TmaProducer {
  template <bool CODES>
  static constexpr int kFullArrivals = CODES ? 128 : 1;

  // Bytes that the boxes of kv tile k0 write (k and v, es bytes an
  // element): whole boxes, and only the pages below T.
  template <typename Rows>
  static __device__ __forceinline__ uint32_t tile_bytes(const Params& p,
                                                        const WgBlock& bk,
                                                        int k0, int bn,
                                                        int es) {
    const int box = Rows::kPaged ? min(p.page, bn) : bn;
    const int n_box = Rows::kPaged ? (min(bn, p.T - k0) + box - 1) / box : 1;
    return 2u * bk.n_ch * n_box * box * 64 * es;
  }

  // Sets the bytes `bar` waits for, then issues the boxes of kv tile k0
  // (k and v, es bytes an element) into dst_k / dst_v, whose 64-column
  // blocks are `cstride` bytes apart with `rowb` bytes a row. Called by a
  // whole warp: lane i looks up and loads page i of the tile (at most 16).
  template <typename Rows>
  static __device__ __forceinline__ void issue(
      const Params& p, const Maps& maps, const WgBlock& bk, const Rows& rows,
      unsigned char* dst_k, unsigned char* dst_v, uint64_t* bar, int k0,
      int bn, int es, int cstride, int rowb) {
    const int lane = threadIdx.x & 31;
    if (lane == 0)
      mbar_arrive_expect_tx(bar, tile_bytes<Rows>(p, bk, k0, bn, es));
    __syncwarp();  // the expected bytes are set before any box lands
    if constexpr (!Rows::kPaged) {
      if (lane == 0) {
        for (int c = 0; c < bk.n_ch; ++c) {
          tma_load_4d(dst_k + c * cstride, &maps.k, bar, c * 64, bk.w.h, k0,
                      bk.w.b);
          tma_load_4d(dst_v + c * cstride, &maps.v, bar, c * 64, bk.w.h, k0,
                      bk.w.b);
        }
      }
    } else {
      const int box = min(p.page, bn);
      if (lane * box < min(bn, p.T - k0)) {
        const int row = (int)rows.row(k0 + lane * box);
        for (int c = 0; c < bk.n_ch; ++c) {
          tma_load_3d(dst_k + c * cstride + lane * box * rowb, &maps.k, bar,
                      c * 64, bk.w.h, row);
          tma_load_3d(dst_v + c * cstride + lane * box * rowb, &maps.v, bar,
                      c * 64, bk.w.h, row);
        }
      }
    }
  }

  template <int DHP, bool CODES, typename Rows>
  static __device__ __forceinline__ void run(const Params& p,
                                             const Maps& maps,
                                             const WgBlock& bk,
                                             const WgSmem<DHP, CODES>& sm) {
    using Sh = WgShape<DHP, CODES>;
    constexpr int BN = Sh::BN;
    const int lt = threadIdx.x & 127;
    if (!CODES && lt >= 32) return;  // bf16: one warp
    if (lt == 0) {
      tma_prefetch_map(&maps.q);
      tma_prefetch_map(&maps.k);
      tma_prefetch_map(&maps.v);
    }
    const Rows rows = Rows::make(p, bk.w.b);
    if (lt == 0) load_q(p, maps, bk, sm.q(), sm.q_full(), Sh::ROWS);
    if constexpr (!CODES) {
      for (int it = 0; it < bk.n_tiles; ++it) {
        const int s = it % Sh::ST;
        const int k0 = (bk.j_lo + it) * BN;
        mbar_wait(sm.empty(s), ((it / Sh::ST) & 1) ^ 1);
        if (Rows::kPaged && k0 + BN > p.T) {
          // rows past T have no page: zeros, as TMA reads past a
          // contiguous T
          const int valid = p.T - k0;
          for (int idx = lt; idx < bk.n_ch * (BN - valid) * 8; idx += 32) {
            const int c = idx / ((BN - valid) * 8);
            const int rem = idx - c * (BN - valid) * 8;
            const int off = c * BN * 128 + swz(valid + (rem >> 3), rem & 7);
            *reinterpret_cast<uint4*>(sm.k(s) + off) =
                make_uint4(0, 0, 0, 0);
            *reinterpret_cast<uint4*>(sm.v(s) + off) =
                make_uint4(0, 0, 0, 0);
          }
          fence_proxy_async();
          __syncwarp();
        }
        issue(p, maps, bk, rows, sm.k(s), sm.v(s), sm.full(s), k0, BN, 2,
              BN * 128, 128);
        __syncwarp();
      }
    } else {
      // codes: warp 0 loads them into the staging ring, the warpgroup
      // converts them into the bf16 stage
      auto stage_codes = [&](int it) {
        const int c = it % Sh::CS;
        issue(p, maps, bk, rows, sm.kc(c), sm.vc(c), sm.code_full(c),
              (bk.j_lo + it) * BN, BN, 1, BN * 64, 64);
      };
      if (lt < 32)
        for (int it = 0; it < min(Sh::CS, bk.n_tiles); ++it)
          stage_codes(it);
      for (int it = 0; it < bk.n_tiles; ++it) {
        const int s = it % Sh::ST, c = it % Sh::CS;
        const int k0 = (bk.j_lo + it) * BN;
        mbar_wait(sm.empty(s), ((it / Sh::ST) & 1) ^ 1);
        store_scales(p, bk, rows, sm, s, k0, lt);
        mbar_wait(sm.code_full(c), (it / Sh::CS) & 1);
        for (int idx = lt; idx < bk.n_ch * BN * 8; idx += 128)
          convert_unit(sm, c, s, idx, min(BN, p.T - k0), p.kv_dtype);
        fence_proxy_async();
        mbar_arrive(sm.full(s));
        named_barrier_sync(1, 128);  // staging buffer c is read
        if (lt < 32 && it + Sh::CS < bk.n_tiles) stage_codes(it + Sh::CS);
      }
    }
  }
};

// cp.async producer: the warpgroup copies 16-byte bf16 or 8-byte code
// chunks, zero-filling rows past T and features past dh.
struct CpAsyncProducer {
  template <bool CODES>
  static constexpr int kFullArrivals = 128;

  template <int DHP, bool CODES, typename Rows>
  static __device__ __forceinline__ void run(const Params& p,
                                             const Maps& maps,
                                             const WgBlock& bk,
                                             const WgSmem<DHP, CODES>& sm) {
    using Sh = WgShape<DHP, CODES>;
    constexpr int BN = Sh::BN;
    constexpr int ES = CODES ? 1 : 2;  // bytes a k/v element
    const int lt = threadIdx.x & 127;
    const unsigned char* kg = static_cast<const unsigned char*>(p.k);
    const unsigned char* vg = static_cast<const unsigned char*>(p.v);
    const Rows rows = Rows::make(p, bk.w.b);
    if (lt == 0) load_q(p, maps, bk, sm.q(), sm.q_full(), Sh::ROWS);
    for (int it = 0; it < bk.n_tiles; ++it) {
      const int s = it % Sh::ST;
      const int k0 = (bk.j_lo + it) * BN;
      const int valid = min(BN, p.T - k0);
      mbar_wait(sm.empty(s), ((it / Sh::ST) & 1) ^ 1);
      store_scales(p, bk, rows, sm, s, k0, lt);
      // unit idx: 64-column block c, row r, 8-feature chunk q
      for (int idx = lt; idx < bk.n_ch * BN * 8; idx += 128) {
        const int c = idx / (BN * 8), rem = idx - c * BN * 8;
        const int r = rem >> 3, q = rem & 7;
        const int col = c * 64 + q * 8;
        const bool ok = r < valid && col < p.dh;
        const long long row = ok ? rows.row(k0 + r) : 0;
        const unsigned char* ks =
            kg + (ok ? (bk.w.k_base + row * p.k_st + col) * ES : 0);
        const unsigned char* vs =
            vg + (ok ? (bk.w.v_base + row * p.v_st + col) * ES : 0);
        if constexpr (CODES) {
          const int off = c * BN * 64 + r * 64 + q * 8;
          cp_async_8(sm.kc(0) + off, ks, ok ? 8 : 0);
          cp_async_8(sm.vc(0) + off, vs, ok ? 8 : 0);
        } else {
          const int off = c * BN * 128 + swz(r, q);
          cp_async_16(sm.k(s) + off, ks, ok ? 16 : 0);
          cp_async_16(sm.v(s) + off, vs, ok ? 16 : 0);
        }
      }
      cp_async_wait_all();
      if constexpr (CODES) {  // each thread converts the units it copied
        for (int idx = lt; idx < bk.n_ch * BN * 8; idx += 128)
          convert_unit(sm, 0, s, idx, valid, p.kv_dtype);
      }
      fence_proxy_async();
      mbar_arrive(sm.full(s));
    }
  }
};

// 2^x: one MUFU.EX2, subnormal results flushed to 0 (they are below the
// resolution of any row sum, which holds a term of 2^0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b,
                                         int scale_d) {
  if constexpr (N == 32) wgmma_ss_n32(d, a, b, scale_d);
  if constexpr (N == 64) wgmma_ss_n64(d, a, b, scale_d);
  if constexpr (N == 96) wgmma_ss_n96(d, a, b, scale_d);
  if constexpr (N == 128) wgmma_ss_n128(d, a, b, scale_d);
}

// acc (64 x DHP) += P (64 x 16, registers) V (16 x DHP rows of the stage
// from v_addr, MN-major); wgmma's N stops at 256, so 320 takes two.
template <int DHP, int BN>
__device__ __forceinline__ void pv_step(float* o, const uint32_t (&a)[4],
                                        uint32_t v_addr) {
  constexpr uint32_t kLbo = BN * 128;  // between 64-column blocks
  if constexpr (DHP == 64) wgmma_rs_n64(o, a, wgmma_desc(v_addr, kLbo, 1024));
  if constexpr (DHP == 128)
    wgmma_rs_n128(o, a, wgmma_desc(v_addr, kLbo, 1024));
  if constexpr (DHP == 256)
    wgmma_rs_n256(o, a, wgmma_desc(v_addr, kLbo, 1024));
  if constexpr (DHP == 320) {
    wgmma_rs_n256(o, a, wgmma_desc(v_addr, kLbo, 1024));
    wgmma_rs_n64(o + 128, a, wgmma_desc(v_addr + 4 * kLbo, kLbo, 1024));
  }
}

// One consumer warpgroup: 64 query rows of the block.
template <int DHP, bool CODES>
__device__ __forceinline__ void consume(const Params& p, const Maps& maps,
                                        const WgBlock& bk,
                                        const WgSmem<DHP, CODES>& sm,
                                        int wg) {
  using Sh = WgShape<DHP, CODES>;
  constexpr int BN = Sh::BN;
  const int lt = threadIdx.x & 127, lane = lt & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = 64 * wg + (lt >> 5) * 16 + g, r1 = r0 + 8;
  const float sl2 = p.scale * kLog2e;
  const Tile& w = bk.w;
  const int pos0 = w.p0 + r0 / p.rep, pos1 = w.p0 + r1 / p.rep;
  // this warpgroup's positions; idle when it holds no row of the block
  const bool idle = 64 * wg >= w.n_rows;
  const int wq_lo = w.p0 + 64 * wg / p.rep;
  const int wq_hi = w.p0 + (min(64 * wg + 63, w.n_rows - 1)) / p.rep;
  // The tiles this warpgroup computes, [t_lo, t_hi) of the block's: those
  // not fully masked for its own rows (a prefix older than the window
  // and a suffix above the diagonal drop out); it only releases the rest.
  int t_lo = 0, t_hi = idle ? 0 : bk.n_tiles;
  if (!idle && p.causal) t_hi = min(t_hi, wq_hi / BN - bk.j_lo + 1);
  if (!idle && p.window > 0 && wq_lo - p.window + 1 > 0)
    t_lo = (wq_lo - p.window + 1) / BN - bk.j_lo;
  t_lo = max(0, min(t_lo, bk.n_tiles));
  t_hi = max(t_lo, t_hi);

  float o[DHP / 2];  // acc
#pragma unroll
  for (int i = 0; i < DHP / 2; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f, al0 = 1.f, al1 = 1.f;
  float sc[BN / 2];  // S, then P
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
  uint32_t pa[BN / 16][4];  // P as bf16 A fragments

  // The two warpgroups take turns to issue their products (named barriers
  // 2 and 3), so that one's softmax runs while the other's products are on
  // the tensor cores; each takes one turn per kv tile of the block.
  static_assert(Sh::NWG == 2, "turns between two warpgroups");
  auto turn_begin = [&]() { named_barrier_sync(2 + wg, 256); };
  auto turn_end = [&]() { named_barrier_arrive(3 - wg, 256); };
  // S = Q K^T of stage s (features past dh are zeros in q and k)
  auto issue_qk = [&](int s, uint32_t q_addr) {
    const uint32_t k_addr = smem_u32(sm.k(s));
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) reg_fence(sc[i]);
#pragma unroll
    for (int i = 0; i < DHP / 2; ++i) reg_fence(o[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DHP / 16; ++kk) {
      // 64-column block kk / 4, 32 bytes a k-step within it
      const uint32_t q_off = (kk >> 2) * Sh::ROWS * 128 + (kk & 3) * 32;
      const uint32_t k_off = (kk >> 2) * BN * 128 + (kk & 3) * 32;
      wgmma_ss<BN>(sc, wgmma_desc(q_addr + q_off, 16, 1024),
                   wgmma_desc(k_addr + k_off, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };
  // acc += P V of stage s, P from pa
  auto issue_pv = [&](int s) {
    const uint32_t v_addr = smem_u32(sm.v(s));
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      pv_step<DHP, BN>(o, pa[kk], v_addr + kk * 16 * 128);
    wgmma_commit();
  };

  // ring stage and phase of the block's tile it
  auto stage = [&](int it) { return it % Sh::ST; };
  auto phase = [&](int it) { return (it / Sh::ST) & 1; };
  auto release = [&](int it) {
    mbar_wait(sm.full(stage(it)), phase(it));
    turn_begin();
    turn_end();
    mbar_arrive(sm.empty(stage(it)));
  };
  // scores to the exp2 domain (codes: times the column's k scale),
  // masked when the tile straddles the diagonal, the window edge or T
  auto scale_scores = [&](int s, int k0, auto masked) {
#pragma unroll
    for (int jb = 0; jb < BN / 8; ++jb) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = jb * 8 + 2 * t4 + e;
        const float f = CODES ? sm.ks(s)[col] : sl2;
        float a = sc[4 * jb + e] * f, b = sc[4 * jb + 2 + e] * f;
        if constexpr (decltype(masked)::value) {
          if (!visible(p, pos0, k0 + col)) a = kNegInf;
          if (!visible(p, pos1, k0 + col)) b = kNegInf;
        }
        sc[4 * jb + e] = a;
        sc[4 * jb + 2 + e] = b;
      }
    }
  };
  // The online softmax of the scores in sc (tile k0, stage s): sc
  // becomes P, and al0 / al1 the factors that rescale acc.
  auto softmax = [&](int s, int k0) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) reg_fence(sc[i]);
    // interior bf16 tiles keep the raw scores and fold the scale into the
    // exponent (one FFMA an element); max(s) * f is max(s * f) for f > 0
    const bool folded = !CODES && sl2 > 0.f &&
                        !(k0 + BN > p.T || (p.causal && k0 + BN - 1 > wq_lo) ||
                          (p.window > 0 && wq_hi - k0 >= p.window));
    if (!folded) {
      if (k0 + BN > p.T || (p.causal && k0 + BN - 1 > wq_lo) ||
          (p.window > 0 && wq_hi - k0 >= p.window))
        scale_scores(s, k0, std::true_type{});
      else
        scale_scores(s, k0, std::false_type{});
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int i = 0; i < BN / 2; i += 4) {
      mx0 = fmaxf(mx0, fmaxf(sc[i], sc[i + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[i + 2], sc[i + 3]));
    }
    if (folded) {
      mx0 *= sl2;
      mx1 *= sl2;
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    al0 = ex2(m0 - mn0);
    al1 = ex2(m1 - mn1);
    // a row that has seen no key yet keeps its masked scores at 0
    const float mu0 = mn0 == kNegInf ? 0.f : mn0;
    const float mu1 = mn1 == kNegInf ? 0.f : mn1;
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
    if (folded) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const bool top = (i & 2) == 0;
        sc[i] = ex2(fmaf(sc[i], sl2, -(top ? mu0 : mu1)));
        if (top)
          sum0 += sc[i];
        else
          sum1 += sc[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const bool top = (i & 2) == 0;
        sc[i] = ex2(sc[i] - (top ? mu0 : mu1));
        if (top)
          sum0 += sc[i];
        else
          sum1 += sc[i];
      }
    }
    l0 = al0 * l0 + sum0;  // this thread's columns; summed at the end
    l1 = al1 * l1 + sum1;
  };
  // P (codes: times the column's v scale) into pa as bf16 A fragments,
  // then acc *= alpha
  auto pack_p = [&](int s) {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const int c0 = kk * 16 + 2 * t4, c1 = c0 + 8;
      float f00 = 1.f, f01 = 1.f, f10 = 1.f, f11 = 1.f;
      if constexpr (CODES) {
        f00 = sm.vs(s)[c0];
        f01 = sm.vs(s)[c0 + 1];
        f10 = sm.vs(s)[c1];
        f11 = sm.vs(s)[c1 + 1];
      }
      pa[kk][0] = pack_bf16(sc[8 * kk] * f00, sc[8 * kk + 1] * f01);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2] * f00, sc[8 * kk + 3] * f01);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4] * f10, sc[8 * kk + 5] * f11);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6] * f10, sc[8 * kk + 7] * f11);
    }
#pragma unroll
    for (int i = 0; i < DHP / 2; ++i) o[i] *= (i & 2) ? al1 : al0;
  };

  const uint32_t q_addr = smem_u32(sm.q()) + 64 * wg * 128;
  mbar_wait(sm.q_full(), 0);
  if (wg == 1) named_barrier_arrive(2, 256);  // warpgroup 0 goes first
  for (int it = 0; it < t_lo; ++it) release(it);
  int s = stage(t_lo);
  if (t_lo < t_hi) {
    // Software pipeline: the Q K^T of tile it is issued before the P V
    // of tile it - 1, so the softmax of tile it runs while that P V is
    // on the tensor cores; a stage is released once its P V is done.
    mbar_wait(sm.full(s), phase(t_lo));
    turn_begin();
    issue_qk(s, q_addr);
    turn_end();
    wgmma_wait<0>();
    softmax(s, (bk.j_lo + t_lo) * BN);
    pack_p(s);
    for (int it = t_lo + 1; it < t_hi; ++it) {
      const int s_pv = s;
      s = stage(it);
      mbar_wait(sm.full(s), phase(it));
      turn_begin();
      issue_qk(s, q_addr);
      issue_pv(s_pv);
      turn_end();
      wgmma_wait<1>();  // Q K^T is done; P V may still run
      softmax(s, (bk.j_lo + it) * BN);
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < DHP / 2; ++i) reg_fence(o[i]);
      mbar_arrive(sm.empty(s_pv));
      pack_p(s);
    }
#pragma unroll
    for (int i = 0; i < DHP / 2; ++i) reg_fence(o[i]);
    wgmma_fence();
    issue_pv(s);
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < DHP / 2; ++i) reg_fence(o[i]);
    mbar_arrive(sm.empty(s));
  }
  for (int it = t_hi; it < bk.n_tiles; ++it) release(it);
  if (wg == 0) turn_begin();  // warpgroup 1's last turn_end

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  // acc / max(l, 1e-30), as a product with one reciprocal a row, in bf16
  // over this warpgroup's rows of q in shared memory (q's layout; its last
  // Q K^T is done), then one TMA store of the block's rows, which drops
  // positions past S and features past dh
  const float d0 = __frcp_rn(fmaxf(l0, 1e-30f));
  const float d1 = __frcp_rn(fmaxf(l1, 1e-30f));
  unsigned char* q_s = reinterpret_cast<unsigned char*>(sm.q());
#pragma unroll
  for (int f = 0; f < DHP / 8; ++f) {
    unsigned char* blk = q_s + (f >> 3) * Sh::ROWS * 128 + 4 * t4;
    *reinterpret_cast<uint32_t*>(blk + swz(r0, f & 7)) =
        pack_bf16(o[4 * f] * d0, o[4 * f + 1] * d0);
    *reinterpret_cast<uint32_t*>(blk + swz(r1, f & 7)) =
        pack_bf16(o[4 * f + 2] * d1, o[4 * f + 3] * d1);
  }
  fence_proxy_async();
  named_barrier_sync(4, 256);  // both warpgroups' rows are in place
  if (wg == 0 && lt == 0) {
    for (int c = 0; c < (p.dh + 63) / 64; ++c)
      tma_store_4d(&maps.out, q_s + c * Sh::ROWS * 128, c * 64,
                   w.h * p.rep, w.p0, w.b);
    tma_store_commit_wait_read();
  }
}

template <int DHP, bool CODES, typename Rows, typename Producer>
__global__ void __launch_bounds__(WgShape<DHP, CODES>::THREADS, 1)
    flash_wgmma_kernel(const __grid_constant__ Params p,
                       const __grid_constant__ Maps maps) {
  using Sh = WgShape<DHP, CODES>;
  extern __shared__ __align__(1024) unsigned char smem[];
  if (smem_u32(smem) & 1023) __trap();  // the swizzle needs 1024 bytes
  const WgSmem<DHP, CODES> sm{smem};
  const WgBlock bk = wg_block(p, Sh::BN);
  // the 64-column blocks past dh are never loaded: zeros for q.k
  for (int c = (p.dh + 63) / 64; c < DHP / 64; ++c) {
    for (int i = threadIdx.x; i < Sh::ROWS * 8; i += Sh::THREADS)
      reinterpret_cast<uint4*>(sm.q())[c * Sh::ROWS * 8 + i] =
          make_uint4(0, 0, 0, 0);
    for (int i = threadIdx.x; i < Sh::ST * Sh::BN * 8; i += Sh::THREADS) {
      const int st = i / (Sh::BN * 8), off = c * Sh::BN * 128 +
                                             (i - st * Sh::BN * 8) * 16;
      *reinterpret_cast<uint4*>(sm.k(st) + off) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(sm.v(st) + off) = make_uint4(0, 0, 0, 0);
    }
  }
  fence_proxy_async();
  if (threadIdx.x == 0) {
    for (int s = 0; s < Sh::ST; ++s) {
      mbar_init(sm.full(s), Producer::template kFullArrivals<CODES>);
      mbar_init(sm.empty(s), 128 * Sh::NWG);
    }
    for (int c = 0; c < Sh::CS; ++c) mbar_init(sm.code_full(c), 1);
    mbar_init(sm.q_full(), 1);
    fence_barrier_init();
  }
  __syncthreads();
  // warp-uniform for the compiler, so that setmaxnreg applies per branch
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  // consumers first: ptxas then allocates their registers by setmaxnreg's
  // count (with the producer's branch first, it spilled the consumers)
  if (wg < Sh::NWG) {
    setmaxnreg_inc<232>();
    consume<DHP, CODES>(p, maps, bk, sm, wg);
  } else {
    setmaxnreg_dec<40>();
    Producer::template run<DHP, CODES, Rows>(p, maps, bk, sm);
  }
}

// ---------------------------------------------------------------------------
// f32 queries: f32 FMA throughout
// ---------------------------------------------------------------------------

// Zero `bytes` of shared memory, then stage the block's f32 query rows.
__device__ __forceinline__ void stage_q(const Params& p, const Tile& w,
                                        unsigned char* smem, int bytes,
                                        float* q_s, int qs) {
  for (int i = threadIdx.x; i < bytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  const int nvec = p.dh / 8;
  for (int idx = threadIdx.x; idx < w.n_rows * nvec; idx += kThreads) {
    const int r = idx / nvec, c = idx - r * nvec;
    load8(q_s + r * qs + c * 8, p.q, row_offset(p, w, r) + c * 8, kFloat32,
          1.f);
  }
}

// Stage kv rows [k0, k0 + bn) into k_s / v_s (row strides ks), zeros past T.
template <typename Rows>
__device__ __forceinline__ void stage_kv(const Params& p, const Tile& w,
                                         const Rows& rows, int k0, int bn,
                                         float* k_s, float* v_s, int ks) {
  const int nvec = p.dh / 8;
  for (int idx = threadIdx.x; idx < bn * nvec; idx += kThreads) {
    const int jr = idx / nvec, c = idx - jr * nvec;
    const int t = k0 + jr;
    float* kd = k_s + jr * ks + c * 8;
    float* vd = v_s + jr * ks + c * 8;
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
      for (int e = 0; e < 2; ++e) {
        reinterpret_cast<uint4*>(kd)[e] = make_uint4(0, 0, 0, 0);
        reinterpret_cast<uint4*>(vd)[e] = make_uint4(0, 0, 0, 0);
      }
    }
  }
}

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
  extern __shared__ __align__(1024) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* k_s = q_s + kRows * LD;
  float* v_s = k_s + BN * LD;
  float* p_s = v_s + BN * LD;

  // the heaviest causal tiles (the last positions) are scheduled first
  const Tile w = block_tile(p, gridDim.x - 1 - blockIdx.x, blockIdx.y,
                            blockIdx.z);
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
// host: tensor maps and dispatch
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded (no link
// against libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// Encodes a map of `rank` dims (innermost first) with byte strides of dims
// 1.. in `strides`; returns 0 or an error code.
int encode(CUtensorMap* map, const void* base, bool codes, int rank,
           const cuuint64_t* dims, const cuuint64_t* strides,
           const cuuint32_t* box) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint32_t one[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(
      map,
      codes ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      rank, const_cast<void*>(base), dims, strides, box, one,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      codes ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

bool stride_ok(long long bytes) {
  return bytes > 0 && bytes % 16 == 0 && bytes < (1ll << 40);
}

// Whether TMA can describe k and v: 16-byte multiples for every stride and
// the feature row; a page that is a multiple of 8 rows and divides the kv
// tile or is a multiple of it.
template <typename Rows>
bool tma_fits(const Params& p, int B, int es, int bn) {
  if (p.T <= 0 || (p.dh * es) % 16 != 0) return false;
  if (!stride_ok(p.k_st * es) || !stride_ok(p.v_st * es)) return false;
  if (Rows::kPaged)
    return p.R > 0 && p.page % 8 == 0 &&
           (bn % p.page == 0 || p.page % bn == 0);
  return B == 1 || (stride_ok(p.k_sb * es) && stride_ok(p.v_sb * es));
}

// Maps of k and v (one of them at a time: base, row and batch strides).
template <typename Rows>
int encode_kv(CUtensorMap* map, const Params& p, int B, const void* base,
              long long st, long long sb, int es, int bn) {
  const cuuint32_t box_rows =
      Rows::kPaged ? (cuuint32_t)std::min(p.page, bn) : (cuuint32_t)bn;
  if (Rows::kPaged) {
    const cuuint64_t dims[3] = {(cuuint64_t)p.dh, (cuuint64_t)p.Hk,
                                (cuuint64_t)p.R};
    const cuuint64_t strides[2] = {(cuuint64_t)p.dh * es,
                                   (cuuint64_t)(st * es)};
    const cuuint32_t box[3] = {64, 1, box_rows};
    return encode(map, base, es == 1, 3, dims, strides, box);
  }
  const cuuint64_t dims[4] = {(cuuint64_t)p.dh, (cuuint64_t)p.Hk,
                              (cuuint64_t)p.T, (cuuint64_t)B};
  // a batch of one: any legal stride (never stepped over)
  const long long sbb = B > 1 ? sb * es : ((st * es * p.T + 15) / 16) * 16;
  const cuuint64_t strides[3] = {(cuuint64_t)p.dh * es,
                                 (cuuint64_t)(st * es), (cuuint64_t)sbb};
  const cuuint32_t box[4] = {64, 1, box_rows, 1};
  return encode(map, base, es == 1, 4, dims, strides, box);
}

template <typename Kernel, typename... Args>
int run(Kernel kernel, int smem_bytes, dim3 grid, int threads,
        cudaStream_t s, const Args&... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, threads, smem_bytes, s>>>(args...);
  return (int)cudaGetLastError();
}

template <int DHP, bool CODES, typename Rows>
int launch_wgmma(Params p, int B, cudaStream_t s) {
  using Sh = WgShape<DHP, CODES>;
  p.n_pos = Sh::ROWS / p.rep;
  const dim3 grid((p.S + p.n_pos - 1) / p.n_pos, p.Hk, B);
  Maps maps;
  {
    const cuuint64_t dims[4] = {(cuuint64_t)p.dh, (cuuint64_t)p.H,
                                (cuuint64_t)p.S, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)p.dh * 2,
                                   (cuuint64_t)p.H * p.dh * 2,
                                   (cuuint64_t)p.S * p.H * p.dh * 2};
    const cuuint32_t box[4] = {64, (cuuint32_t)p.rep, (cuuint32_t)p.n_pos,
                               1};
    int e = encode(&maps.q, p.q, false, 4, dims, strides, box);
    if (e == 0) e = encode(&maps.out, p.out, false, 4, dims, strides, box);
    if (e != 0) return e;
  }
  const int es = CODES ? 1 : 2;
  if (tma_fits<Rows>(p, B, es, Sh::BN)) {
    int e = encode_kv<Rows>(&maps.k, p, B, p.k, p.k_st, p.k_sb, es, Sh::BN);
    if (e == 0)
      e = encode_kv<Rows>(&maps.v, p, B, p.v, p.v_st, p.v_sb, es, Sh::BN);
    if (e != 0) return e;
    return run(flash_wgmma_kernel<DHP, CODES, Rows, TmaProducer>, Sh::kSmem,
               grid, Sh::THREADS, s, p, maps);
  }
  maps.k = maps.v = maps.q;  // unused by the cp.async producer
  return run(flash_wgmma_kernel<DHP, CODES, Rows, CpAsyncProducer>,
             Sh::kSmem, grid, Sh::THREADS, s, p, maps);
}

template <int DHP, typename Rows>
int launch_dh(Params p, int B, int q_dtype, cudaStream_t s) {
  if (q_dtype == kBFloat16) {
    if (p.kv_dtype == kBFloat16) return launch_wgmma<DHP, false, Rows>(p, B, s);
    return launch_wgmma<DHP, true, Rows>(p, B, s);
  }
  p.n_pos = kRows / p.rep;
  const dim3 grid((p.S + p.n_pos - 1) / p.n_pos, p.Hk, B);
  return run(flash_f32_kernel<DHP, Rows>, F32Shape<DHP>::kSmem, grid, kThreads,
             s, p);
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
  if (B == 0 || p.S == 0) return 0;
  if (p.dh <= 64) return launch_dh<64, Rows>(p, B, q_dtype, s);
  if (p.dh <= 128) return launch_dh<128, Rows>(p, B, q_dtype, s);
  if (p.dh <= 256) return launch_dh<256, Rows>(p, B, q_dtype, s);
  return launch_dh<320, Rows>(p, B, q_dtype, s);
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
    int B, int S, int H, int Hk, int dh, int nk, int page, int R,
    long long table_sb, long long k_st, long long v_st, long long ks_st,
    long long vs_st, int causal, int window, float scale, int q_dtype,
    int kv_dtype, void* stream) {
  using namespace repro_torch;
  if (page < 1 || nk < 0 || R < 0 || (long long)nk * page > 0x7fffffffLL ||
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
  p.R = R;
  return launch<PagedRows>(p, B, q_dtype, static_cast<cudaStream_t>(stream));
}

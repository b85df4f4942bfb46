// The set-attention core shared by K1 (csrc/btc_attention.cu) and K2
// (csrc/set_attention.cu), for Hopper (sm_90a).
//
// For every row b, head h and query i, in the order of the JAX package's
// `_xla_attention_btc` (multimodal_flows_tpu/ops/attention.py:158-193):
//   s_j   = (q[b,h,i] . k[b,h,j]) * scale
//   s_j  += key_mask[b,j]                        (optional, (B, Tk) fp32)
//   s_j  += bias[b,h,i,j]                        (kBias, fp32 or bf16, strided)
//   s_j  += (j > i ? -1e9 : 0)                   (kCausal, Tq == Tk, no bias)
//   s_j   = -1e9 where segments[b,i] != segments[b,j]   (kSeg, Tq == Tk)
//   out[b,h,i] = sum_j softmax_j(s) v[b,h,j]     (exact softmax, fp32)
// q, k, v, the bias and the output are each a pointer and four element
// strides of a (B, H, T, D) view; a zero bias stride broadcasts.
//
// Both dtypes share one machinery: a block is (row b, 64 queries, head h)
// and one warpgroup of 4 warps, the 64 rows of a `wgmma` tile; its loads go
// by TMA (`cp.async.bulk.tensor.4d` with a tensor map, 128-byte swizzle)
// and complete on `mbarrier`s; key tiles of 64; the scores and the online
// (flash-style) softmax stay fp32 in the accumulator layout, masked scores
// are -1e9 (finite) as in the plain version.
//
// fp32 q/k/v (the path users run by default): `attention_kernel_tf32`.  At
// the packed-row batch (B = 128 rows x T = 128 tokens, H = 4) one call
// moves 67 MB of q/k/v/out at C = 256, plus 33.5 MB of (B, H, T, T) bias in
// K2: about 30 us at 3.35 TB/s.  Its 2.15 GFLOP take 13 us at the TF32
// tensor-core rate with three products per multiply.  What bounded the
// earlier design (3xTF32 `mma.sync`, `cp.async` tiles of 32 keys) was not
// either but each tile's chain: a `cp.async.wait_group 0`, a barrier, the
// split pass and a second barrier, 4.3-5.3x the byte bound.  The design:
//   - Tensor cores at fp32 accuracy: `wgmma.m64nNk8.f32.tf32.tf32` with the
//     3xTF32 split, lo*hi + hi*lo + hi*hi a step of 8, summed in fp32
//     (error near 1e-6 against about 1e-3 for plain TF32;
//     tests/test_torch_fp32_plan.py emulates it).  The tensor core ignores
//     the low 13 bits of a .tf32 operand, so the raw fp32 values TMA writes
//     are the hi parts, trunc(x); only lo = tf32(x - trunc(x)) is made, by
//     one thread pass when a tile lands.
//   - TF32 `wgmma` reads both shared-memory operands K-major only (the
//     transpose bits are f16 / bf16's).  S = Q K^T: Q's and K's rows are
//     K-major as TMA writes them; Q_lo comes from registers (made from Q's
//     raw rows per pass), K_lo from the pass.  P V: P's hi and lo are made
//     in registers from the score accumulators (the A operand from
//     registers); V must be K-major along the keys, so the pass writes V^T's
//     hi and lo parts from V's raw tile, its keys in P's fragment order.
//   - The head's dims pass in chunks of 64 rows x 64 columns (32 at head
//     size <= 32): each needed key tile is K's ceil(hs / 64) passes, then
//     the V parts of the block's output columns, each one chunk of a ring of
//     1-4 stages with a `full` and an `empty` mbarrier; thread 0 loads the
//     chunk `stages` on once every thread has arrived on a stage's `empty`
//     barrier.  Q's rows of the whole head stay in shared memory.  Up to
//     head size 64 a tile's K and V chunks are waited for together and split
//     in one pass between two barriers.  Without segments the first loads
//     go out before the key mask is read.
//   - Past a head size of 128 a block takes one slice of 128 output
//     columns (grid z = H x slices x splits) and recomputes S; up to 128 the
//     whole head.
//   - What bounds it now is the chain of waits of a block with few key
//     tiles (2 at the packed rows), so the plan buys blocks an SM first:
//     the stages that let the most blocks share an SM (the registers are
//     bounded for 4 at head size <= 32, 2 past it), then the most stages.
//   - Where a call's blocks fill at most half of the blocks the card holds
//     at once, the key tiles of a (row, head, query tile) are split across
//     blocks: each writes its partial (O unnormalised, the rows' max and
//     sum) and `merge_splits` combines them before the output is
//     normalised, so the softmax stays exact.  A merge costs about 5 us, so
//     a share keeps at least 8 chunks of work.
//   - Key tiles no query of the block needs are not loaded
//     (`BlockNeeds`): under segments those whose interval of ids misses the
//     block's 64 queries; under kCausal (GPT's full forward) those past the
//     block's last query, whose blocks start with the last query tile, the
//     longest.  Every pair of a skipped tile would score -1e9 plus a small
//     term, so each of its probabilities is exactly 0 in fp32 for a query
//     that keeps one unmasked key of its own: every query does, itself
//     (Tq == Tk), and the tile holding it is never skipped.
//   - The bias is read per accumulator fragment from global memory when a
//     tile begins.
//   - q/k/v whose strides miss TMA's rules (odd head sizes) are staged by
//     the block's threads into the same layout.
//   - The output goes through the work chunks to 16-byte stores of whole
//     rows (4-6% faster than the fragments' own stores at the packed rows).
//   The measured alternatives that lost (PERF.md): 3-4 stages at
//   head size 64, one block an SM (K1 at C = 256 0.107 against 0.077 ms);
//   key splits where the blocks already fill the card (the wide jets: 3
//   splits 0.029 against 0.021 ms unsplit); the block's own tile first
//   under segments (4-7% slower); reading the bias only for same-segment
//   pairs at head size 64 (4% slower for K2 at C = 256; at 32 it is faster
//   and kept); the bias loaded a tile ahead, into registers or into L2
//   (5-15% slower for K2); skipping the key mask's zeros in the softmax
//   when a call has none (10-30% slower: ptxas re-allocated the kernel).
//   The host plans the call (`ops/set_attention.py:fp32_plan`): q/k/v by
//   TMA or not, the ring's stages, the slices, the key splits and the
//   shared memory, which the entry checks against `fp32_smem`.
//
// bf16 q/k/v (the encoders' compute_dtype="bfloat16"): `attention_kernel_bf16`.
// What bounds it here is not its bytes (33.5 MB at C = 256 without a bias,
// 10 us) but the chain of round trips of a small block: with Tk <= 256 a
// block has at most 8 key tiles of 32, and the earlier mma.sync design
// waited for Q, then for each K/V tile (`cp.async.wait_group 0` and a
// barrier), then read the bias of the tile from global memory into
// registers: 4.4-6.3x above its byte bound, slower than one
// `scaled_dot_product_attention` call.  The design:
//   - Its loads are in flight together: the first thread issues the TMA
//     loads of Q and of the K/V tiles of 64 keys, with the bias block beside
//     each tile, each key tile completing on its own `mbarrier`, while the
//     threads read the key mask and the segment ids.  With Tk <= 256 and
//     head size <= 128 the whole row fits in shared memory (at most 217 KB),
//     so the ring of key tiles never wraps and no tile waits for another's
//     consumer (kRing false: the layout and the loop of the kernel before
//     key rings).  The block computes as tiles land.
//   - Past 256 keys (kRing) the key tiles pass through a ring of S stages
//     (2-4, as many as fit), each with a `full` and an `empty` mbarrier:
//     thread 0 loads the tile S needed tiles on into a stage once every
//     thread has arrived on its `empty` barrier; the bias block of a tile
//     travels in its stage.
//   - Head sizes past 128 (`attention_kernel_bf16_sliced`): a block takes
//     one slice of 128 output columns; its query rows stay in shared memory
//     as chunks of 64 x 128, and each needed key tile passes through a ring
//     of chunks of 64 keys x 128 (K's passes, then V's slice); the bias is
//     read per fragment.
//   - Under segments only the key tiles whose interval of ids meets the
//     block's 64 queries are loaded, once the ids are in: measured against
//     loading every tile at once, 2-3% faster for K1 and level for K2 at the
//     packed rows.
//   - Q, K and V land in the swizzled K-major layout that `wgmma` reads
//     (128-byte swizzle, 64-byte at head size <= 32, head dims past the
//     head size zero-filled by the tensor map's bounds).  S = Q K^T is
//     `wgmma.m64n64k16` with both operands in shared memory; P V is
//     `wgmma.m64nDk16` with P from registers (rounded to bf16 in the
//     accumulator-to-A layout) and V in shared memory read MN-major through
//     the transpose bit.
//   - The bias block of a key tile (64 queries x 64 keys) lands by TMA
//     in boxes of 128-byte rows, swizzled, where the bias's key stride is
//     1 and its row stride and base meet TMA's 16-byte rules (the
//     co-occurrence (B,H,T,T) bias and the pair biases at T % 4 == 0; a
//     zero stride is a dimension of size 1); the fragments read it from
//     there.  Other biases (T = 150: rows of 600 bytes) are read per
//     fragment from global memory.
//   - q/k/v whose strides miss TMA's rules (odd head sizes) are staged by
//     the block's threads into the same swizzled layout.
//   - The output goes through shared memory to 16-byte stores.
//   The measured alternative that lost: two warpgroups a block (one block
//   per (row, head) at T = 128, the K/V tiles shared), K2 4-6% slower and
//   K1 within 4% (PERF.md).
// The host side plans the call (`ops/set_attention.py:bf16_plan`): which
// operands go by TMA, the ring's stages, the slices and the shared memory,
// which the entry checks against `bf16_smem`.
// Shapes: any Tq, Tk and head size.  What bounds them is a block's 227 KB
// of shared memory (`fp32_smem`, `bf16_smem`): the key mask and segment
// ids of a row are staged whole (8 Tk bytes: 32 KB at Tk = 4096), and the
// query rows of the whole head (fp32 256 hs bytes, bf16 in slices 128 hs);
// with the tiles that leaves Tk up to about 16,000 at head size 128 and
// head sizes up to about 700 at Tk = 1024.  The launch refuses a call past
// it (invalid value), and the host plans raise first, naming it.  Offsets
// are 64-bit; the grid bounds Tq by 65,535 query tiles and H x slices (x
// key splits) by 65,535.

#pragma once

#include <climits>
#include <cstdint>

#include <type_traits>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace set_attention_core {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxHs = 128;  // the widest head a block holds whole; wider heads go in slices
constexpr int kSliceD = kMaxHs;  // output columns of a block of the sliced forms
constexpr int kMaxSmem = 232448;  // the shared memory one block may use (227 KB)
constexpr float kNeg = -1e9f;
constexpr int kPad = -1;  // the segment id of pad tokens

// element strides of a (B, H, T, D) view
struct Strides {
  long long b, h, t, d;
};

// q, k, v and out of element type T (float or __nv_bfloat16), the bias of
// BiasT (float, or __nv_bfloat16 with bf16 q/k/v)
template <typename T, typename BiasT = float>
struct ParamsT {
  const T* q;
  Strides sq;
  const T* k;
  Strides sk;
  const T* v;
  Strides sv;
  const float* key_mask;  // (B, Tk) or null
  const BiasT* bias;      // read only by the kBias kernels
  Strides sb;
  const int* segments;    // (B, Tq), Tq == Tk; read only by the kSeg kernels
  T* out;
  Strides so;
  int Tq, Tk, hs;
  float scale;
};

using Params = ParamsT<float>;
using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

// Segment intervals.  Under segments a key tile is needed by a group of
// query rows when the intervals of their segment ids (pads excluded) meet,
// or when both hold pads (id kPad, a flag of its own).  The intervals of
// every key tile (kTileKeys keys, one warp a tile) go to `lo`, `hi` and
// `pad` in shared memory, ceil(Tk / kTileKeys) ints each: a tile's test is
// then made when the tile is reached, at any Tk.
template <int kTileKeys>
__device__ __forceinline__ void tile_intervals(const int* sg, int Tk, int* lo, int* hi,
                                               int* pad) {
  const int n_tiles = (Tk + kTileKeys - 1) / kTileKeys;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = warp; t < n_tiles; t += kWarps) {
    int a = INT_MAX, z = INT_MIN;
    bool p = false;
#pragma unroll
    for (int u = 0; u < kTileKeys / 32; ++u) {
      const int j = t * kTileKeys + 32 * u + lane;
      if (j < Tk) {
        const int id = sg[j];
        if (id == kPad) p = true;
        else a = min(a, id), z = max(z, id);
      }
    }
    a = __reduce_min_sync(0xffffffffu, a);
    z = __reduce_max_sync(0xffffffffu, z);
    p = __any_sync(0xffffffffu, p);
    if (lane == 0) lo[t] = a, hi[t] = z, pad[t] = p;
  }
}

// The interval of the ids of the warp's rows: row i for the lanes where
// `row`; every lane gets it.
__device__ __forceinline__ void rows_interval(const int* sg, int Tq, int i, bool row, int& lo,
                                              int& hi, bool& pad) {
  const bool real = row && i < Tq;
  const int id = real ? sg[i] : kPad;
  lo = __reduce_min_sync(0xffffffffu, id == kPad ? INT_MAX : id);
  hi = __reduce_max_sync(0xffffffffu, id == kPad ? INT_MIN : id);
  pad = __any_sync(0xffffffffu, real && id == kPad);
}

__device__ __forceinline__ bool meets(int lo, int hi, bool pad, int tlo, int thi, int tpad) {
  return (lo <= thi && tlo <= hi) || (pad && tpad);
}

// The bias of the warp's accumulator fragments for the key tile at key0
// (kNB blocks of 8 keys): two adjacent keys a thread, read as one pair
// where `vec` (key stride 1, rows aligned to two values), 0 past Tq or Tk.
// With kSameSeg a pair is read only where one of its keys shares the row's
// segment id (`sg`, `seg_row`): the other scores become -1e9 whatever
// their bias (the fp32 core at head size <= 32, where it measured faster;
// at 64 it was slower).
template <typename BiasT, int kNB, bool kSameSeg = false>
__device__ __forceinline__ void load_bias(float (&bias_v)[kNB][4], const BiasT* bb,
                                          const Strides& sb, const int (&rows)[2], int Tq,
                                          int Tk, int key0, int c, bool vec,
                                          const int* sg = nullptr, const int* seg_row = nullptr) {
#pragma unroll
  for (int n = 0; n < kNB; ++n) {
    const int j = key0 + 8 * n + 2 * c;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x0 = 0.f, x1 = 0.f;
      bool read = rows[r] < Tq;
      if constexpr (kSameSeg) {
        read = read && ((j < Tk && sg[j] == seg_row[r]) || (j + 1 < Tk && sg[j + 1] == seg_row[r]));
      }
      if (read) {
        const BiasT* bp = bb + rows[r] * sb.t + j * sb.d;
        if (vec && j + 1 < Tk) {
          float2 x;
          if constexpr (std::is_same_v<BiasT, float>) {
            x = *reinterpret_cast<const float2*>(bp);
          } else {
            x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bp));
          }
          x0 = x.x, x1 = x.y;
        } else {
          if (j < Tk) x0 = to_float(bp[0]);
          if (j + 1 < Tk) x1 = to_float(bp[sb.d]);
        }
      }
      bias_v[n][2 * r] = x0, bias_v[n][2 * r + 1] = x1;
    }
  }
}

// One key tile of the online softmax, in the accumulator layout: the raw
// scores `s` of the warp's 16 rows (`rows`) against the tile's 8 * kNB keys
// become the unnormalised probabilities exp(score - running max), after
// the scale, the key mask, the bias or the causal term and the segment
// test; the running max `m`, the thread's part of each row's sum `l` and
// the output accumulators `o` are rescaled when the max grows.
template <bool kBias, bool kSeg, bool kCausal, int kNB, int kOut>
__device__ __forceinline__ void softmax_tile(float (&s)[kNB][4], const float (&bias_v)[kNB][4],
                                             const float* km, const int* sg,
                                             const int (&seg_row)[2], const int (&rows)[2],
                                             int key0, int Tk, int c, float scale, float (&m)[2],
                                             float (&l)[2], float (&o)[kOut][4]) {
  float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < kNB; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const int j = key0 + 8 * n + 2 * c + (e & 1);
      float x = -INFINITY;  // keys past Tk take no part
      if (j < Tk) {
        x = s[n][e] * scale + km[j];
        if constexpr (kBias) x += bias_v[n][e];
        if constexpr (kCausal) x += j > rows[r] ? kNeg : 0.f;  // the bias form's causal bias
        if constexpr (kSeg) {
          if (sg[j] != seg_row[r]) x = kNeg;
        }
      }
      s[n][e] = x;
      tile_max[r] = fmaxf(tile_max[r], x);
    }
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mx = fmaxf(m[r], quad_max(tile_max[r]));
    alpha[r] = expf(m[r] - mx);  // 0 on the first tile
    m[r] = mx;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int n = 0; n < kNB; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] = expf(s[n][e] - m[e >> 1]);
      l[e >> 1] += s[n][e];
    }
  }
#pragma unroll
  for (int n = 0; n < kOut; ++n) {
    o[n][0] *= alpha[0], o[n][1] *= alpha[0];
    o[n][2] *= alpha[1], o[n][3] *= alpha[1];
  }
}

// ---------------------------------------------------------------- bf16
//
// The bf16 path (see the header).  Fragment layouts: the accumulator of
// `wgmma.m64nN` gives warp w of the warpgroup rows 16w + g and 16w + g + 8
// (g = lane / 4, c = lane % 4) and, in each block of 8 columns, columns 2c
// and 2c + 1, registers [n][0..1] and [n][2..3]: the layout of mma.m16n8.
// The A operand from registers is that of mma.m16n8k16 per warp: rows g,
// g + 8, columns 2c, 2c + 1 (registers 0, 1) and 2c + 8, 2c + 9 (2, 3).  So
// P's A fragment for 16 keys is the score accumulators of its two 8-key
// blocks, rounded in pairs.

constexpr int kTileRows = 64;                      // query rows of a block, keys of a tile
constexpr int kBiasBoxBytes = kTileRows * 128;     // a bias box: 64 rows of 128 bytes
constexpr int kScratchInts = 32;                   // the segment intervals

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Byte offsets of the bf16 kernels' shared memory from a 1024-aligned
// base, for head sizes up to `dmax` (32, 64 or 128; kSliceD in slices),
// Tk keys, `bias_tile` bytes of bias staged a key tile (0 where the bias is
// read from global memory or absent) and a ring of `stages` stages.
// Whole heads (slices == 1): the query tile (or the output's staging rows),
// then `stages` K tiles, V tiles and bias blocks; with stages == the key
// tiles (Tk <= 256) the whole row is resident and the ring never wraps, as
// before key rings.  In slices (hs > 128): the query rows of the whole head
// as `slices` chunks of 64 x kSliceD, then `stages` chunks, each a K pass
// or V's slice.  Then the key mask, the segment ids, the scratch
// of the tile intervals, and the barriers: Q, one `full` a stage and, where
// a stage is reused, one `empty` a stage.  `total` is what the launch asks
// for, 1024 bytes of slack for the alignment included.
// ops/set_attention.py:bf16_smem_bytes computes the same numbers.
struct Bf16Smem {
  int q, k, v, bias, km, sg, scratch, bar, n_bars, total;
};

// ints of the scratch: the query rows' interval (6), then the key tiles'
__host__ __device__ constexpr int bf16_scratch_ints(int Tk) {
  return 8 + 3 * ((Tk + kTileRows - 1) / kTileRows) > kScratchInts
             ? 8 + 3 * ((Tk + kTileRows - 1) / kTileRows)
             : kScratchInts;
}

__host__ __device__ inline Bf16Smem bf16_smem(int dmax, int Tk, int bias_tile, int stages,
                                              int slices) {
  const int tile = kTileRows * dmax * 2;            // 64 rows of Q, K or V
  const int out = kTileRows * (dmax + 8) * 2;       // the output's staging rows
  const int n_tiles = (Tk + kTileRows - 1) / kTileRows;
  Bf16Smem s{};
  s.q = 0;
  if (slices > 1) {
    s.k = s.v = slices * tile;  // >= out
    s.bias = s.k + stages * tile;
  } else {
    s.k = round_up(tile > out ? tile : out, 1024);
    s.v = s.k + stages * tile;
    s.bias = s.v + stages * tile;
  }
  s.km = s.bias + stages * bias_tile;
  s.sg = s.km + 4 * Tk;
  s.scratch = s.sg + 4 * Tk;
  s.bar = round_up(s.scratch + 4 * bf16_scratch_ints(Tk), 8);
  s.n_bars = 1 + stages + (slices > 1 || stages < n_tiles ? stages : 0);
  s.total = s.bar + 8 * s.n_bars + 1024;
  return s;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The byte offset `off` (from a 1024-aligned base) as TMA's 128-byte or
// 64-byte swizzle places it: bits 4-6 (4-5) XOR bits 7-9 (7-8).
template <int kSwBytes>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  return off ^ (((off >> 7) & (kSwBytes == 128 ? 7u : 3u)) << 4);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// arrive on `bar`, expecting `bytes` of TMA transactions in its phase
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  if (bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(bytes)
                 : "memory");
  } else {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
  }
}

// wait for the phase `parity` of `bar` to complete; a phase that has not
// completed after about 2^32 cycles (2 s) is a fault, and traps
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  for (int spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == 0) start = clock64();
    else if (clock64() - start > (1ll << 32)) __trap();
  }
}

// one 4-d box of `map` at (c0, c1, c2, c3) into shared memory at `dst`,
// completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// generic-proxy writes to shared memory, made visible to TMA and wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Matrix descriptors of `wgmma` for the swizzled layouts TMA writes
// (start address, leading / stride byte offsets in 16-byte units, layout
// 1 = 128-byte swizzle, 2 = 64-byte).  K-major: rows of kSwBytes, 8-row
// groups 8 * kSwBytes apart (the leading offset is unused).  MN-major: 8
// rows of K kSwBytes apart, 8-row groups 8 * kSwBytes apart, atoms of
// kSwBytes along MN `atom_stride` bytes apart.
template <int kSwBytes>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  constexpr uint64_t layout = kSwBytes == 128 ? 1 : 2;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(8 * kSwBytes >> 4) << 32) | (layout << 62);
}

template <int kSwBytes>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr, uint32_t atom_stride) {
  constexpr uint64_t layout = kSwBytes == 128 ? 1 : 2;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(atom_stride >> 4) << 16) |
         (static_cast<uint64_t>(8 * kSwBytes >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accesses of registers that an in-flight
// wgmma writes across the fence, wait or commit around it
template <int kN>
__device__ __forceinline__ void fence_regs(float (&d)[kN][4]) {
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e])::"memory");
  }
}

// d (64 x 64, fp32) = A (64 x 16, K-major in shared memory) B (16 x 64, K-major), plus d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 32, fp32) = A (64 x 16 bf16, registers) B (16 x 32, MN-major in shared memory)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[4][4], const uint32_t (&a)[4],
                                            uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64, fp32) = A (64 x 16 bf16, registers) B (16 x 64, MN-major in shared memory)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4], const uint32_t (&a)[4],
                                            uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d (64 x 128, fp32) = A (64 x 16 bf16, registers) B (16 x 128, MN-major in shared memory)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4], const uint32_t (&a)[4],
                                            uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <int kN>
__device__ __forceinline__ void wgmma_rs(float (&d)[kN][4], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (kN == 4) wgmma_rs_n32(d, a, desc_b, 1);
  else if constexpr (kN == 8) wgmma_rs_n64(d, a, desc_b, 1);
  else wgmma_rs_n128(d, a, desc_b, 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// The key tiles of 64 that a block's 64 query rows at q0 need: every
// tile; under segments (kSeg) the tiles whose interval of ids meets the
// rows' (`meets`); under kCausal the tiles whose first key is at or before
// the block's last query.  Every thread calls `init` once the segment ids
// are in shared memory, and gets the same answers; `scratch` holds
// bf16_scratch_ints(Tk) ints.
template <bool kSeg, bool kCausal = false>
struct BlockNeeds {
  const int* lo;
  const int* hi;
  const int* pad;
  int n_tiles, rlo, rhi, last;
  bool rpad;

  __device__ __forceinline__ void init(const int* sg, int* scratch, int Tq, int Tk, int q0) {
    n_tiles = (Tk + kTileRows - 1) / kTileRows;
    if constexpr (kCausal) last = min(q0 + kTileRows, Tq) - 1;
    if constexpr (kSeg) {
      int* tl = scratch + 8;
      lo = tl, hi = tl + n_tiles, pad = tl + 2 * n_tiles;
      tile_intervals<kTileRows>(sg, Tk, tl, tl + n_tiles, tl + 2 * n_tiles);
      const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
      if (warp < 2) {  // query rows q0 + 32 warp + lane
        int a, z;
        bool p;
        rows_interval(sg, Tq, q0 + 32 * warp + lane, true, a, z, p);
        if (lane == 0) scratch[warp] = a, scratch[2 + warp] = z, scratch[4 + warp] = p;
      }
      __syncthreads();
      rlo = min(scratch[0], scratch[1]);
      rhi = max(scratch[2], scratch[3]);
      rpad = scratch[4] || scratch[5];
    }
  }

  __device__ __forceinline__ bool needs(int t) const {
    if constexpr (kSeg) return meets(rlo, rhi, rpad, lo[t], hi[t], pad[t]);
    else if constexpr (kCausal) return t * kTileRows <= last;
    else return true;
  }

  // the first needed tile after t and before `end`, -1 past the last
  __device__ __forceinline__ int next_before(int t, int end) const {
    for (int u = t + 1; u < end; ++u) {
      if (needs(u)) return u;
    }
    return -1;
  }

  __device__ __forceinline__ int next(int t) const { return next_before(t, n_tiles); }

  // the needed tiles of first.. first + 31 as a bit mask
  __device__ __forceinline__ uint32_t window(int first) const {
    const int n = min(32, n_tiles - first);
    if constexpr (!kSeg) return n == 32 ? 0xffffffffu : (1u << n) - 1u;
    uint32_t mask = 0;
    for (int i = 0; i < n; ++i) mask |= static_cast<uint32_t>(needs(first + i)) << i;
    return mask;
  }
};

// Rows r0.. r0 + 63 of one (T, D) bf16 view into a 64-row tile at `dst`
// (1024-aligned), in the swizzled K-major layout TMA writes: column blocks
// of kCols values, dims >= hs and rows >= T as zeros.  For the views TMA
// cannot read (strides that are not multiples of 16 bytes).
template <int kMaxD>
__device__ __forceinline__ void stage_tile(unsigned char* dst, const bf16* src, long long st,
                                           long long sd, int r0, int T, int hs) {
  constexpr int kCols = kMaxD < 64 ? kMaxD : 64;
  constexpr int kSwBytes = 2 * kCols;
  for (int e = threadIdx.x; e < kTileRows * kMaxD; e += kThreads) {
    const int r = e / kMaxD, d = e % kMaxD, j = r0 + r;
    const bf16 x = d < hs && j < T ? src[j * st + d * sd] : __float2bfloat16(0.f);
    const uint32_t off = (d / kCols) * (kTileRows * kSwBytes) + r * kSwBytes + (d % kCols) * 2;
    *reinterpret_cast<bf16*>(dst + swizzle<kSwBytes>(off)) = x;
  }
}

// The kernel's arguments: the strided views, the tensor maps of q, k, v
// and the bias (read only where `qkv_tma` / `bias_tma`), the extents of
// the bias map's head and row dimensions (1 where the bias broadcasts) and
// the stages of the ring.
template <typename BiasT>
struct Bf16Args {
  CUtensorMap qmap, kmap, vmap, bmap;
  ParamsT<bf16, BiasT> p;
  int qkv_tma, bias_tma, bias_heads, bias_rows, stages;
};

// One block: row b = blockIdx.x, queries 64 * blockIdx.y.., head h =
// blockIdx.z; one warpgroup.
template <int kMaxD, bool kBias, bool kSeg, bool kRing, typename BiasT>
__global__ void __launch_bounds__(kThreads)
    attention_kernel_bf16(const __grid_constant__ Bf16Args<BiasT> a) {
  constexpr int kCols = kMaxD < 64 ? kMaxD : 64;   // values a swizzled row
  constexpr int kSwBytes = 2 * kCols;              // 128, or 64 at head size <= 32
  constexpr int kColBlocks = kMaxD / kCols;        // 2 at head size 128
  constexpr int kBlockBytes = kTileRows * kSwBytes;
  constexpr int kTileBytes = kColBlocks * kBlockBytes;
  constexpr int kOut = kMaxD / 8;                  // 8-wide output blocks
  constexpr int kBoxKeys = 128 / sizeof(BiasT);    // keys a bias box: 32 fp32, 64 bf16
  constexpr int kBiasTile = kTileRows * kTileRows * sizeof(BiasT);
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const ParamsT<bf16, BiasT>& p = a.p;
  const int hs = p.hs, Tq = p.Tq, Tk = p.Tk;
  const int n_tiles = (Tk + kTileRows - 1) / kTileRows;
  // key tiles in shared memory at once: all of them (kRing false, the
  // stage of a tile is its index), or a ring of S stages that wraps
  const int S = a.stages;
  constexpr bool wraps = kRing;
  const bool bias_tma = kBias && a.bias_tma;
  const Bf16Smem L = bf16_smem(kMaxD, Tk, bias_tma ? kBiasTile : 0, S, 1);
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  float* km = reinterpret_cast<float*>(sm + L.km);
  int* sg = reinterpret_cast<int*>(sm + L.sg);
  // barrier 0: Q; 1 + st: stage st full; 1 + S + st: stage st empty (where it wraps)
  const uint32_t bar = base + L.bar;

  const int b = blockIdx.x;
  const int h = blockIdx.z;
  const int q0 = blockIdx.y * kTileRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const bf16* kb = p.k + b * p.sk.b + h * p.sk.h;
  const bf16* vb = p.v + b * p.sv.b + h * p.sv.h;

  // the TMA loads of key tile t (K, V and the bias block) into stage st,
  // or an arrival alone where nothing goes by TMA or the tile is not loaded
  const int bias_h = a.bias_heads > 1 ? h : 0, bias_b = a.bias_rows > 1 ? b : 0;
  auto issue_tile = [&](int t, int st, bool load) {
    const uint32_t full = bar + 8 * (1 + st);
    mbar_arrive_tx(full, load ? (a.qkv_tma ? 2 * kTileBytes : 0) + (bias_tma ? kBiasTile : 0)
                              : 0);
    if (!load) return;
    if (a.qkv_tma) {
      for (int cb = 0; cb < kColBlocks; ++cb) {
        const uint32_t off = st * kTileBytes + cb * kBlockBytes;
        tma_load(base + L.k + off, &a.kmap, full, cb * kCols, t * kTileRows, h, b);
        tma_load(base + L.v + off, &a.vmap, full, cb * kCols, t * kTileRows, h, b);
      }
    }
    if (bias_tma) {
      for (int x = 0; x < kTileRows / kBoxKeys; ++x) {
        tma_load(base + L.bias + st * kBiasTile + x * kBiasBoxBytes, &a.bmap, full,
                 t * kTileRows + x * kBoxKeys, q0, bias_h, bias_b);
      }
    }
  };
  // K and V of key tile t staged by the threads into stage st
  auto stage_kv = [&](int t, int st) {
    stage_tile<kMaxD>(sm + L.k + st * kTileBytes, kb, p.sk.t, p.sk.d, t * kTileRows, Tk, hs);
    stage_tile<kMaxD>(sm + L.v + st * kTileBytes, vb, p.sv.t, p.sv.d, t * kTileRows, Tk, hs);
  };

  // in flight at once: Q, the first S key tiles' K, V and bias (under
  // segments once the needed tiles are known, below), the key mask and
  // the segment ids.  In a ring the k-th needed key tile takes stage k % S.
  int next_issue = -1;  // (thread 0) the next needed tile to load, -1 when none
  if (tid == 0) {
    for (int i = 0; i < L.n_bars; ++i) mbar_init(bar + 8 * i, i <= S ? 1 : kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_arrive_tx(bar, a.qkv_tma ? kTileBytes : 0);
    if (a.qkv_tma) {
      for (int cb = 0; cb < kColBlocks; ++cb) {
        tma_load(base + L.q + cb * kBlockBytes, &a.qmap, bar, cb * kCols, q0, h, b);
      }
    }
    if (!kSeg) {
      for (int t = 0; t < S; ++t) issue_tile(t, t, true);
      next_issue = wraps ? S : -1;
    }
  }
  for (int j = tid; j < Tk; j += kThreads) {
    const long long at = static_cast<long long>(b) * Tk + j;
    km[j] = p.key_mask ? p.key_mask[at] : 0.f;
    if (kSeg) sg[j] = p.segments[at];
  }
  if (!a.qkv_tma) {
    stage_tile<kMaxD>(sm + L.q, p.q + b * p.sq.b + h * p.sq.h, p.sq.t, p.sq.d, q0, Tq, hs);
    fence_proxy_async();
  }
  __syncthreads();  // the barriers, key mask, segment ids and staged Q

  BlockNeeds<kSeg> need;
  need.init(sg, reinterpret_cast<int*>(sm + L.scratch), Tq, Tk, q0);
  if (kSeg && tid == 0) {  // only the tiles the block needs
    if constexpr (wraps) {
      int t = need.next(-1);
      for (int k = 0; k < S && t >= 0; ++k, t = need.next(t)) issue_tile(t, k, true);
      next_issue = t;
    } else {
      for (int t = 0; t < n_tiles; ++t) issue_tile(t, t, need.needs(t));
    }
  }
  if (!wraps && !a.qkv_tma) {  // the resident tiles, staged once
    for (int t = 0; t < n_tiles; ++t) {
      if (need.needs(t)) stage_kv(t, t);
    }
    fence_proxy_async();
    __syncthreads();
  }

  const int lr = warp * 16 + g;  // the thread's first local row; the other is lr + 8
  const int rows[2] = {q0 + lr, q0 + lr + 8};
  int seg_row[2] = {0, 0};
  if constexpr (kSeg) {
#pragma unroll
    for (int r = 0; r < 2; ++r) seg_row[r] = rows[r] < Tq ? sg[rows[r]] : -1;
  }
  const BiasT* bb = kBias ? p.bias + b * p.sb.b + h * p.sb.h : nullptr;
  const bool bias_vec = kBias && p.sb.d == 1 && p.sb.t % 2 == 0 && aligned(bb, 2 * sizeof(BiasT));

  float o[kOut][4];
#pragma unroll
  for (int n = 0; n < kOut; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  mbar_wait(bar, 0);
  int st = 0;         // the stage of the tile in turn
  uint32_t use = 0;   // the phase of its barriers: how often the stage was used, mod 2
  uint32_t mask = 0;  // the needed tiles of the window of 32 in turn
  for (int t = 0; t < n_tiles; ++t) {
    if ((t & 31) == 0) mask = need.window(t);
    const bool needed = (mask >> (t & 31)) & 1u;
    if constexpr (!wraps) {  // each tile in its own stage, waited for in order
      mbar_wait(bar + 8 * (1 + t), 0);
      if (!needed) continue;
      st = t;
    } else {
      if (!needed) continue;
      if (!a.qkv_tma) {  // the threads stage the tile in its turn
        __syncthreads();  // every warp is done with the stage's previous tile
        stage_kv(t, st);
        fence_proxy_async();
        __syncthreads();
      }
      mbar_wait(bar + 8 * (1 + st), use);
    }
    const int key0 = t * kTileRows;
    const uint32_t k_at = base + L.k + st * kTileBytes, v_at = base + L.v + st * kTileBytes;

    // S = Q K^T: the 64 rows against the tile's 64 keys (head dims past
    // hs are zeros).  The accumulators are zeroed before the fence: a
    // register the products write that is defined inside their stage would
    // serialize them.
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kMaxD / 16; ++ks) {
      const uint32_t off = (16 * ks / kCols) * kBlockBytes + (16 * ks % kCols) * 2;
      wgmma_ss_n64(s, desc_k_major<kSwBytes>(base + L.q + off), desc_k_major<kSwBytes>(k_at + off),
                   1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    float bias_v[8][4];
    if constexpr (kBias) {
      if (bias_tma) {  // from the tile's boxes: row lr (+ 8), keys 8n + 2c, + 1
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int kt = 8 * n + 2 * c;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const uint32_t off = st * kBiasTile + (kt / kBoxKeys) * kBiasBoxBytes +
                                 (lr + 8 * r) * 128 + (kt % kBoxKeys) * sizeof(BiasT);
            const unsigned char* at = sm + L.bias + swizzle<128>(off);
            float2 x;
            if constexpr (std::is_same_v<BiasT, float>) {
              x = *reinterpret_cast<const float2*>(at);
            } else {
              x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(at));
            }
            bias_v[n][2 * r] = x.x, bias_v[n][2 * r + 1] = x.y;
          }
        }
      } else {
        load_bias(bias_v, bb, p.sb, rows, Tq, Tk, key0, c, bias_vec);
      }
    }

    softmax_tile<kBias, kSeg, false>(s, bias_v, km, sg, seg_row, rows, key0, Tk, c, p.scale, m,
                                     l, o);

    // P V: P rounded to bf16 in the A layout, 16 keys a step
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs(o, pa[kk], desc_mn_major<kSwBytes>(v_at + 16 * kk * kSwBytes, kBlockBytes));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);

    if constexpr (wraps) {  // release the stage; thread 0 loads the tile S needed tiles on
      const uint32_t empty = bar + 8 * (1 + S + st);
      mbar_arrive_tx(empty, 0);
      if (tid == 0 && next_issue >= 0) {
        mbar_wait(empty, use);
        issue_tile(next_issue, st, true);
        next_issue = need.next(next_issue);
      }
      if (++st == S) st = 0, use ^= 1u;
    }
  }

  // the output through shared memory (Q's rows, no longer read) to
  // 16-byte stores
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = 1.f / quad_sum(l[r]);
  __syncthreads();  // every warp's products are done with Q
  constexpr int kPitch = kMaxD + 8;  // values a staged row: conflict-free pair writes
  bf16* os = reinterpret_cast<bf16*>(sm + L.q);
#pragma unroll
  for (int n = 0; n < kOut; ++n) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      *reinterpret_cast<__nv_bfloat162*>(os + (lr + 8 * r) * kPitch + 8 * n + 2 * c) =
          __floats2bfloat162_rn(o[n][2 * r] * inv[r], o[n][2 * r + 1] * inv[r]);
    }
  }
  __syncthreads();
  bf16* ob = p.out + b * p.so.b + h * p.so.h;
  const int n_rows = min(kTileRows, Tq - q0);
  if (p.so.d == 1 && p.so.t % 8 == 0 && hs % 8 == 0 && aligned(ob, 16)) {
    const int chunks = hs / 8;
    for (int e = tid; e < n_rows * chunks; e += kThreads) {
      const int r = e / chunks, ch = e - r * chunks;
      *reinterpret_cast<uint4*>(ob + (q0 + r) * p.so.t + 8 * ch) =
          *reinterpret_cast<const uint4*>(os + r * kPitch + 8 * ch);
    }
  } else {
    for (int e = tid; e < n_rows * hs; e += kThreads) {
      const int r = e / hs, d = e - r * hs;
      ob[(q0 + r) * p.so.t + d * p.so.d] = os[r * kPitch + d];
    }
  }
}

// The bf16 sliced form, head sizes past kMaxHs (the `wgmma` templates and
// the accumulator registers stop at 128 output columns, and a whole head's
// K and V tiles would not leave room for a ring).  As in the fp32 sliced
// form, a block takes kSliceD output columns (blockIdx.z = h * n_slices +
// slice) and its 64 query rows stay in shared memory, here as n_slices
// chunks of 64 x kSliceD in the swizzled K-major layout.  Each needed key
// tile passes through a ring of `stages` chunks of 64 keys x kSliceD: K's
// n_slices passes (S = Q K^T accumulated over `wgmma.m64n64k16`), then V's
// slice (`wgmma.m64n128k16`, P from registers).  Thread 0 loads chunk
// c + stages into the stage of chunk c once every thread has arrived on
// its `empty` barrier.  The bias is read per fragment from global memory.
template <bool kBias, bool kSeg, typename BiasT>
__global__ void __launch_bounds__(kThreads)
    attention_kernel_bf16_sliced(const __grid_constant__ Bf16Args<BiasT> a) {
  constexpr int kCols = 64;                       // values a swizzled row
  constexpr int kSwBytes = 128;
  constexpr int kColBlocks = kSliceD / kCols;     // 2
  constexpr int kBlockBytes = kTileRows * kSwBytes;
  constexpr int kTileBytes = kColBlocks * kBlockBytes;  // a chunk: 16 KB
  constexpr int kOut = kSliceD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const ParamsT<bf16, BiasT>& p = a.p;
  const int hs = p.hs, Tq = p.Tq, Tk = p.Tk;
  const int S = a.stages;
  const int n_slices = (hs + kSliceD - 1) / kSliceD;
  const int parts = n_slices + 1;  // chunks a key tile: K's passes, then V's slice
  const Bf16Smem L = bf16_smem(kSliceD, Tk, 0, S, n_slices);
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  float* km = reinterpret_cast<float*>(sm + L.km);
  int* sg = reinterpret_cast<int*>(sm + L.sg);
  const uint32_t bar = base + L.bar;  // 0: Q; 1 + st: stage st full; 1 + S + st: empty

  const int b = blockIdx.x;
  const int h = blockIdx.z / n_slices;
  const int col0 = (blockIdx.z - h * n_slices) * kSliceD;
  const int q0 = blockIdx.y * kTileRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const bf16* qb = p.q + b * p.sq.b + h * p.sq.h;
  const bf16* kb = p.k + b * p.sk.b + h * p.sk.h;
  const bf16* vb = p.v + b * p.sv.b + h * p.sv.h;

  // a chunk's first column; both of its column blocks of 64 are loaded,
  // dims past hs as zeros (TMA's fill past the map's bounds, a whole box
  // included), so every product runs all kSliceD / 16 steps unpredicated
  auto first_col = [&](int part) { return part < n_slices ? part * kSliceD : col0; };
  auto issue_chunk = [&](int t, int part, int st) {
    const uint32_t full = bar + 8 * (1 + st);
    const int c0 = first_col(part);
    mbar_arrive_tx(full, a.qkv_tma ? kTileBytes : 0);
    if (!a.qkv_tma) return;
    const CUtensorMap* map = part < n_slices ? &a.kmap : &a.vmap;
    for (int cb = 0; cb < kColBlocks; ++cb) {
      tma_load(base + L.k + st * kTileBytes + cb * kBlockBytes, map, full, c0 + cb * kCols,
               t * kTileRows, h, b);
    }
  };

  if (tid == 0) {
    for (int i = 0; i < L.n_bars; ++i) mbar_init(bar + 8 * i, i <= S ? 1 : kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_arrive_tx(bar, a.qkv_tma ? n_slices * kTileBytes : 0);
    if (a.qkv_tma) {
      for (int part = 0; part < n_slices; ++part) {
        for (int cb = 0; cb < kColBlocks; ++cb) {
          tma_load(base + L.q + part * kTileBytes + cb * kBlockBytes, &a.qmap, bar,
                   part * kSliceD + cb * kCols, q0, h, b);
        }
      }
    }
  }
  for (int j = tid; j < Tk; j += kThreads) {
    const long long at = static_cast<long long>(b) * Tk + j;
    km[j] = p.key_mask ? p.key_mask[at] : 0.f;
    if (kSeg) sg[j] = p.segments[at];
  }
  if (!a.qkv_tma) {
    for (int part = 0; part < n_slices; ++part) {
      const int c0 = part * kSliceD;
      stage_tile<kSliceD>(sm + L.q + part * kTileBytes, qb + c0 * p.sq.d, p.sq.t, p.sq.d, q0, Tq,
                          min(kSliceD, hs - c0));
    }
    fence_proxy_async();
  }
  __syncthreads();

  BlockNeeds<kSeg> need;
  need.init(sg, reinterpret_cast<int*>(sm + L.scratch), Tq, Tk, q0);
  int next_t = -1, next_part = 0;  // (thread 0) the next chunk to load
  if (tid == 0) {
    next_t = need.next(-1);
    for (int st = 0; st < S && next_t >= 0; ++st) {
      issue_chunk(next_t, next_part, st);
      if (++next_part == parts) next_part = 0, next_t = need.next(next_t);
    }
  }

  const int lr = warp * 16 + g;
  const int rows[2] = {q0 + lr, q0 + lr + 8};
  int seg_row[2] = {0, 0};
  if constexpr (kSeg) {
#pragma unroll
    for (int r = 0; r < 2; ++r) seg_row[r] = rows[r] < Tq ? sg[rows[r]] : -1;
  }
  const BiasT* bb = kBias ? p.bias + b * p.sb.b + h * p.sb.h : nullptr;
  const bool bias_vec = kBias && p.sb.d == 1 && p.sb.t % 2 == 0 && aligned(bb, 2 * sizeof(BiasT));

  float o[kOut][4];
#pragma unroll
  for (int n = 0; n < kOut; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  mbar_wait(bar, 0);
  int st = 0;         // the stage of the chunk in turn
  uint32_t use = 0;   // the phase of its barriers
  // wait for chunk `part` of key tile t in stage st (staged by the threads
  // where TMA cannot read q/k/v); `release` frees the stage, and thread 0
  // loads the chunk `stages` on into it
  auto acquire = [&](int t, int part) {
    if (!a.qkv_tma) {
      const int c0 = first_col(part);
      const bool is_k = part < n_slices;
      __syncthreads();  // every warp is done with the stage's previous chunk
      const Strides& sx = is_k ? p.sk : p.sv;
      stage_tile<kSliceD>(sm + L.k + st * kTileBytes, (is_k ? kb : vb) + c0 * sx.d, sx.t, sx.d,
                          t * kTileRows, Tk, min(kSliceD, hs - c0));
      fence_proxy_async();
      __syncthreads();
    }
    mbar_wait(bar + 8 * (1 + st), use);
  };
  auto release = [&]() {
    const uint32_t empty = bar + 8 * (1 + S + st);
    mbar_arrive_tx(empty, 0);
    if (tid == 0 && next_t >= 0) {
      mbar_wait(empty, use);
      issue_chunk(next_t, next_part, st);
      if (++next_part == parts) next_part = 0, next_t = need.next(next_t);
    }
    if (++st == S) st = 0, use ^= 1u;
  };
  uint32_t mask = 0;  // the needed tiles of the window of 32 in turn
  for (int t = 0; t < need.n_tiles; ++t) {
    if ((t & 31) == 0) mask = need.window(t);
    if (!((mask >> (t & 31)) & 1u)) continue;
    // S = Q K^T over the head dims < hs, kSliceD at a time (zeroed outside
    // the products' stage, as in `attention_kernel_bf16`)
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    for (int part = 0; part < n_slices; ++part) {
      acquire(t, part);
      const uint32_t at = base + L.k + st * kTileBytes;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kSliceD / 16; ++ks) {
        const uint32_t off = (16 * ks / kCols) * kBlockBytes + (16 * ks % kCols) * 2;
        wgmma_ss_n64(s, desc_k_major<kSwBytes>(base + L.q + part * kTileBytes + off),
                     desc_k_major<kSwBytes>(at + off), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      release();
    }

    // the scores are whole: softmax, then P V on the slice
    const int key0 = t * kTileRows;
    float bias_v[8][4];
    if constexpr (kBias) load_bias(bias_v, bb, p.sb, rows, Tq, Tk, key0, c, bias_vec);
    softmax_tile<kBias, kSeg, false>(s, bias_v, km, sg, seg_row, rows, key0, Tk, c, p.scale, m,
                                     l, o);
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    acquire(t, n_slices);
    const uint32_t at = base + L.k + st * kTileBytes;
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs(o, pa[kk], desc_mn_major<kSwBytes>(at + 16 * kk * kSwBytes, kBlockBytes));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    release();
  }

  // the slice through shared memory (the query rows, no longer read)
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = 1.f / quad_sum(l[r]);
  __syncthreads();
  constexpr int kPitch = kSliceD + 8;
  bf16* os = reinterpret_cast<bf16*>(sm + L.q);
#pragma unroll
  for (int n = 0; n < kOut; ++n) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      *reinterpret_cast<__nv_bfloat162*>(os + (lr + 8 * r) * kPitch + 8 * n + 2 * c) =
          __floats2bfloat162_rn(o[n][2 * r] * inv[r], o[n][2 * r + 1] * inv[r]);
    }
  }
  __syncthreads();
  bf16* ob = p.out + b * p.so.b + h * p.so.h + col0 * p.so.d;
  const int n_rows = min(kTileRows, Tq - q0);
  const int width = min(kSliceD, hs - col0);
  if (p.so.d == 1 && p.so.t % 8 == 0 && width % 8 == 0 && aligned(ob, 16)) {
    const int chunks = width / 8;
    for (int e = tid; e < n_rows * chunks; e += kThreads) {
      const int r = e / chunks, ch = e - r * chunks;
      *reinterpret_cast<uint4*>(ob + (q0 + r) * p.so.t + 8 * ch) =
          *reinterpret_cast<const uint4*>(os + r * kPitch + 8 * ch);
    }
  } else {
    for (int e = tid; e < n_rows * width; e += kThreads) {
      const int r = e / width, d = e - r * width;
      ob[(q0 + r) * p.so.t + d * p.so.d] = os[r * kPitch + d];
    }
  }
}

// ---------------------------------------------------------------- fp32
//
// The fp32 path (see the header): 3xTF32 on `wgmma`, the loads of the bf16
// path.  Fragment layouts as in the bf16 path, with the A operand from
// registers of `wgmma...k8.tf32` that of mma.m16n8k8's tf32 A per warp:
// registers 0..3 hold (g, c), (g + 8, c), (g, c + 4), (g + 8, c + 4).  So
// P's A fragment for 8 keys is the score accumulators of one 8-key block
// with the keys taken in the order 0, 2, 4, 6, 1, 3, 5, 7 (column c is key
// 2c, column c + 4 key 2c + 1), with no shuffle, and V^T is written in that
// key order.

constexpr int kBlockBytes32 = kTileRows * 128;  // a column block: 64 rows of 32 fp32

// The tensor core reads a .tf32 operand's sign, exponent and top 10
// mantissa bits and ignores the low 13, so a raw fp32 value serves as its
// own hi part, trunc(x); lo is what the truncation drops, rounded to TF32.
__device__ __forceinline__ float tf32_lo(float x) {
  return __uint_as_float(to_tf32(x - __uint_as_float(__float_as_uint(x) & 0xffffe000u)));
}

// byte offset of (row r, column d) in a chunk of 64 rows as TMA writes it:
// column blocks of 32 fp32 (128-byte rows, swizzled)
__device__ __forceinline__ uint32_t chunk_off(int r, int d) {
  return swizzle<128>((d >> 5) * kBlockBytes32 + r * 128 + (d & 31) * 4);
}

// Byte offsets of the fp32 kernel's shared memory from a 1024-aligned base,
// for a block of `out_cols` output columns (32, 64, or 128 for head sizes
// past 64, in slices past 128) in chunks of w = min(out_cols, 64) columns
// (64 rows x w fp32): the query rows of the whole head as ceil(hs / w)
// chunks, `stages` chunks of the ring (a K pass or a V part of a key tile
// each), the work chunks (K's lo part, V^T's hi and lo parts: three up to
// head size 64, where a tile's K and V are split in one pass; two past it,
// K's lo part taking V^T's hi part's place), the key
// mask, the segment ids, the scratch of the tile intervals and the
// barriers: Q, one `full` and one `empty` a stage.  `total` is what the
// launch asks for, 1024 bytes of slack for the alignment included.
// ops/set_attention.py:fp32_smem_bytes computes the same numbers.
struct Fp32Smem {
  int q, stage, work, km, sg, scratch, bar, n_bars, total;
};

__host__ __device__ inline Fp32Smem fp32_smem(int out_cols, int hs, int Tk, int stages) {
  const int w = out_cols < 64 ? out_cols : 64;
  const int chunk = kTileRows * w * 4;
  Fp32Smem s{};
  s.q = 0;
  s.stage = (hs + w - 1) / w * chunk;
  s.work = s.stage + stages * chunk;
  s.km = s.work + (out_cols <= 64 ? 3 : 2) * chunk;
  s.sg = s.km + 4 * Tk;
  s.scratch = s.sg + 4 * Tk;
  s.bar = round_up(s.scratch + 4 * bf16_scratch_ints(Tk), 8);
  s.n_bars = 1 + 2 * stages;
  s.total = s.bar + 8 * s.n_bars + 1024;
  return s;
}

// Rows r0.. r0 + 63 of one (T, D) fp32 view into a chunk at `dst`
// (1024-aligned) in the layout TMA writes, columns >= width and rows >= T
// as zeros.  For the views TMA cannot read.
template <int kW>
__device__ __forceinline__ void stage_chunk(unsigned char* dst, const float* src, long long st,
                                            long long sd, int r0, int T, int width) {
  for (int e = threadIdx.x; e < kTileRows * kW; e += kThreads) {
    const int r = e / kW, d = e % kW, j = r0 + r;
    *reinterpret_cast<float*>(dst + chunk_off(r, d)) =
        d < width && j < T ? src[j * st + d * sd] : 0.f;
  }
}

// K's lo part beside its raw chunk, in the same layout
template <int kW>
__device__ __forceinline__ void split_lo(const unsigned char* raw, unsigned char* lo) {
  for (int e = threadIdx.x; e < kTileRows * kW / 4; e += kThreads) {
    const float4 x = reinterpret_cast<const float4*>(raw)[e];
    reinterpret_cast<float4*>(lo)[e] =
        make_float4(tf32_lo(x.x), tf32_lo(x.y), tf32_lo(x.z), tf32_lo(x.w));
  }
}

// V's raw chunk (64 keys x kW columns) to V^T's hi and lo parts: kW rows of
// 64 keys, K-major in column blocks of 32 keys (kW * 128 bytes each), the
// keys of each 8 in P's order.  A warp takes 32 keys of one column: its
// stores hit 32 banks.
template <int kW>
__device__ __forceinline__ void split_transposed(const unsigned char* raw, unsigned char* hi,
                                                 unsigned char* lo) {
  for (int e = threadIdx.x; e < kTileRows * kW / 4; e += kThreads) {
    const int j = e & (kTileRows - 1), u = e / kTileRows;  // key j, columns 4u.. 4u + 3
    const float4 x = *reinterpret_cast<const float4*>(raw + chunk_off(j, 4 * u));
    const int pos = (j & ~7) | ((j & 1) << 2) | ((j & 7) >> 1);
    const float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t off =
          swizzle<128>((pos >> 5) * (kW * 128) + (4 * u + i) * 128 + (pos & 31) * 4);
      *reinterpret_cast<float*>(hi + off) = v[i];
      *reinterpret_cast<float*>(lo + off) = tf32_lo(v[i]);
    }
  }
}

// d[kOff..] (64 x 64, fp32) += A (64 x 8 tf32, K-major in shared memory) B (8 x 64, K-major)
template <int kOff, int kRows>
__device__ __forceinline__ void tf32_ss_n64(float (&d)[kRows][4], uint64_t desc_a,
                                            uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[kOff + 0][0]), "+f"(d[kOff + 0][1]), "+f"(d[kOff + 0][2]), "+f"(d[kOff + 0][3]),
        "+f"(d[kOff + 1][0]), "+f"(d[kOff + 1][1]), "+f"(d[kOff + 1][2]), "+f"(d[kOff + 1][3]),
        "+f"(d[kOff + 2][0]), "+f"(d[kOff + 2][1]), "+f"(d[kOff + 2][2]), "+f"(d[kOff + 2][3]),
        "+f"(d[kOff + 3][0]), "+f"(d[kOff + 3][1]), "+f"(d[kOff + 3][2]), "+f"(d[kOff + 3][3]),
        "+f"(d[kOff + 4][0]), "+f"(d[kOff + 4][1]), "+f"(d[kOff + 4][2]), "+f"(d[kOff + 4][3]),
        "+f"(d[kOff + 5][0]), "+f"(d[kOff + 5][1]), "+f"(d[kOff + 5][2]), "+f"(d[kOff + 5][3]),
        "+f"(d[kOff + 6][0]), "+f"(d[kOff + 6][1]), "+f"(d[kOff + 6][2]), "+f"(d[kOff + 6][3]),
        "+f"(d[kOff + 7][0]), "+f"(d[kOff + 7][1]), "+f"(d[kOff + 7][2]), "+f"(d[kOff + 7][3])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d[kOff..] (64 x 32, fp32) += A (64 x 8 tf32, registers) B (8 x 32, K-major in shared memory)
template <int kOff, int kRows>
__device__ __forceinline__ void tf32_rs_n32(float (&d)[kRows][4], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[kOff + 0][0]), "+f"(d[kOff + 0][1]), "+f"(d[kOff + 0][2]), "+f"(d[kOff + 0][3]),
        "+f"(d[kOff + 1][0]), "+f"(d[kOff + 1][1]), "+f"(d[kOff + 1][2]), "+f"(d[kOff + 1][3]),
        "+f"(d[kOff + 2][0]), "+f"(d[kOff + 2][1]), "+f"(d[kOff + 2][2]), "+f"(d[kOff + 2][3]),
        "+f"(d[kOff + 3][0]), "+f"(d[kOff + 3][1]), "+f"(d[kOff + 3][2]), "+f"(d[kOff + 3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[kOff..] (64 x 64, fp32) += A (64 x 8 tf32, registers) B (8 x 64, K-major in shared memory)
template <int kOff, int kRows>
__device__ __forceinline__ void tf32_rs_n64(float (&d)[kRows][4], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[kOff + 0][0]), "+f"(d[kOff + 0][1]), "+f"(d[kOff + 0][2]), "+f"(d[kOff + 0][3]),
        "+f"(d[kOff + 1][0]), "+f"(d[kOff + 1][1]), "+f"(d[kOff + 1][2]), "+f"(d[kOff + 1][3]),
        "+f"(d[kOff + 2][0]), "+f"(d[kOff + 2][1]), "+f"(d[kOff + 2][2]), "+f"(d[kOff + 2][3]),
        "+f"(d[kOff + 3][0]), "+f"(d[kOff + 3][1]), "+f"(d[kOff + 3][2]), "+f"(d[kOff + 3][3]),
        "+f"(d[kOff + 4][0]), "+f"(d[kOff + 4][1]), "+f"(d[kOff + 4][2]), "+f"(d[kOff + 4][3]),
        "+f"(d[kOff + 5][0]), "+f"(d[kOff + 5][1]), "+f"(d[kOff + 5][2]), "+f"(d[kOff + 5][3]),
        "+f"(d[kOff + 6][0]), "+f"(d[kOff + 6][1]), "+f"(d[kOff + 6][2]), "+f"(d[kOff + 6][3]),
        "+f"(d[kOff + 7][0]), "+f"(d[kOff + 7][1]), "+f"(d[kOff + 7][2]), "+f"(d[kOff + 7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int kN>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[kN][4]) {
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[n][e])::"memory");
  }
}

__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }

// The kernel's arguments: the strided views, the tensor maps of q, k and v
// (read only where `qkv_tma`), the stages of the ring and the key splits;
// with splits > 1 each block writes its partial (O unnormalised, then the
// rows' max and sum) to `part` and `merge_splits` finishes the rows.
struct Fp32Args {
  CUtensorMap qmap, kmap, vmap;
  Params p;
  float* part;  // O (splits, B, H, Tq, hs), then m and l (splits, B, H, Tq) each
  int B, H, qkv_tma, stages, splits;
};

// One block: row b = blockIdx.x, queries 64 * blockIdx.y.. (the causal form
// takes the last, longest, first), blockIdx.z = ((h * slices) + slice) *
// splits + split; one warpgroup.  kOut output columns (32, 64 or 128; a
// slice past head size 128); the head's dims pass in chunks of kW.  Up to
// head size 64 a key tile is one K chunk and one V chunk, waited for and
// split together (two barriers a tile); past it each chunk in turn.  The
// registers are bounded for 4 blocks an SM at head size <= 32 and 2 past
// it, as the host plan's shared memory is.
template <int kOut, bool kBias, bool kSeg, bool kCausal>
__global__ void __launch_bounds__(kThreads, kOut == 32 ? 4 : 2)
    attention_kernel_tf32(const __grid_constant__ Fp32Args a) {
  constexpr int kW = kOut < 64 ? kOut : 64;     // columns of a chunk
  constexpr int kChunkBytes = kTileRows * kW * 4;
  constexpr int kNV = kOut / kW;                // V parts of the block's columns
  constexpr int kOutN = kOut / 8;               // 8-wide output blocks
  constexpr int kVtBlock = kW * 128;            // V^T: kW rows of 32 keys
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const Params& p = a.p;
  const int hs = p.hs, Tq = p.Tq, Tk = p.Tk;
  const int S = a.stages;
  const int n_k = (hs + kW - 1) / kW;  // K passes of a key tile, Q's chunks
  const int slices = (hs + kOut - 1) / kOut;
  const Fp32Smem L = fp32_smem(kOut, hs, Tk, S);
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  float* km = reinterpret_cast<float*>(sm + L.km);
  int* sg = reinterpret_cast<int*>(sm + L.sg);
  const uint32_t bar = base + L.bar;  // 0: Q; 1 + st: stage st full; 1 + S + st: empty

  const int b = blockIdx.x;
  const int split = blockIdx.z % a.splits;
  const int hz = blockIdx.z / a.splits;
  const int h = hz / slices;
  const int col0 = (hz - h * slices) * kOut;  // the block's first output column
  const int q0 = (kCausal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kTileRows;
  const int n_v = min(kNV, (hs - col0 + kW - 1) / kW);  // V parts with columns < hs
  const int parts = n_k + n_v;  // chunks a key tile: K's passes, then V's parts
  const int n_tiles = (Tk + kTileRows - 1) / kTileRows;
  const int t_lo = split * n_tiles / a.splits, t_hi = (split + 1) * n_tiles / a.splits;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const float* qb = p.q + b * p.sq.b + h * p.sq.h;
  const float* kb = p.k + b * p.sk.b + h * p.sk.h;
  const float* vb = p.v + b * p.sv.b + h * p.sv.h;

  auto first_col = [&](int part) { return part < n_k ? part * kW : col0 + (part - n_k) * kW; };
  auto issue_chunk = [&](int t, int part, int st) {
    const uint32_t full = bar + 8 * (1 + st);
    mbar_arrive_tx(full, a.qkv_tma ? kChunkBytes : 0);
    if (!a.qkv_tma) return;
    const CUtensorMap* map = part < n_k ? &a.kmap : &a.vmap;
    for (int cb = 0; cb < kW / 32; ++cb) {
      tma_load(base + L.stage + st * kChunkBytes + cb * kBlockBytes32, map, full,
               first_col(part) + 32 * cb, t * kTileRows, h, b);
    }
  };

  // The needed key tiles of this split, ascending, through the ring.
  // Without segments they are known at once and every load goes out before
  // the key mask is read; under segments once the ids are in.  (Taking the
  // block's own tile first under segments, so that its loads went out
  // before the ids, was 4-7% slower at the packed rows.)
  BlockNeeds<kSeg, kCausal> need;
  auto next_tile = [&](int t) { return need.next_before(t, t_hi); };
  int next_t = -1, next_part = 0;  // (thread 0) the next chunk to load
  auto produce = [&]() {  // the first `stages` chunks
    next_t = next_tile(t_lo - 1);
    for (int st = 0; st < S && next_t >= 0; ++st) {
      issue_chunk(next_t, next_part, st);
      if (++next_part == parts) next_part = 0, next_t = next_tile(next_t);
    }
  };
  if constexpr (!kSeg) need.init(sg, reinterpret_cast<int*>(sm + L.scratch), Tq, Tk, q0);
  if (tid == 0) {
    for (int i = 0; i < L.n_bars; ++i) mbar_init(bar + 8 * i, i <= S ? 1 : kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_arrive_tx(bar, a.qkv_tma ? n_k * kChunkBytes : 0);
    if (a.qkv_tma) {
      for (int part = 0; part < n_k; ++part) {
        for (int cb = 0; cb < kW / 32; ++cb) {
          tma_load(base + L.q + part * kChunkBytes + cb * kBlockBytes32, &a.qmap, bar,
                   part * kW + 32 * cb, q0, h, b);
        }
      }
    }
    if (!kSeg) produce();
  }
  for (int j = tid; j < Tk; j += kThreads) {
    const long long at = static_cast<long long>(b) * Tk + j;
    km[j] = p.key_mask ? p.key_mask[at] : 0.f;
    if (kSeg) sg[j] = p.segments[at];
  }
  if (!a.qkv_tma) {
    for (int part = 0; part < n_k; ++part) {
      stage_chunk<kW>(sm + L.q + part * kChunkBytes, qb + part * kW * p.sq.d, p.sq.t, p.sq.d, q0,
                      Tq, min(kW, hs - part * kW));
    }
    fence_proxy_async();
  }
  __syncthreads();  // the barriers, key mask, segment ids and staged Q
  if constexpr (kSeg) {
    need.init(sg, reinterpret_cast<int*>(sm + L.scratch), Tq, Tk, q0);
    if (tid == 0) produce();
  }

  const int lr = warp * 16 + g;  // the thread's first local row; the other is lr + 8
  const int rows[2] = {q0 + lr, q0 + lr + 8};
  int seg_row[2] = {0, 0};
  if constexpr (kSeg) {
#pragma unroll
    for (int r = 0; r < 2; ++r) seg_row[r] = rows[r] < Tq ? sg[rows[r]] : -1;
  }
  const float* bb = kBias ? p.bias + b * p.sb.b + h * p.sb.h : nullptr;
  const bool bias_vec = kBias && p.sb.d == 1 && p.sb.t % 2 == 0 && aligned(bb, 8);

  float o[kOutN][4];
#pragma unroll
  for (int n = 0; n < kOutN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  mbar_wait(bar, 0);
  int st = 0;        // the stage of the chunk in turn
  uint32_t use = 0;  // the phase of its barriers
  // wait for chunk `part` of key tile t in stage `at`, phase `phase`
  // (staged by the threads where TMA cannot read q/k/v); `release` frees
  // the stage of the chunk in turn, and thread 0 loads the chunk `stages`
  // on into it
  auto wait_chunk = [&](int t, int part, int at, uint32_t phase) {
    if (!a.qkv_tma) {
      const bool is_k = part < n_k;
      const int c0 = first_col(part);
      __syncthreads();  // every warp is done with the stage's previous chunk
      const Strides& sx = is_k ? p.sk : p.sv;
      stage_chunk<kW>(sm + L.stage + at * kChunkBytes, (is_k ? kb : vb) + c0 * sx.d, sx.t, sx.d,
                      t * kTileRows, Tk, min(kW, hs - c0));
      fence_proxy_async();
    }
    mbar_wait(bar + 8 * (1 + at), phase);
  };
  auto release = [&]() {
    const uint32_t empty = bar + 8 * (1 + S + st);
    mbar_arrive_tx(empty, 0);
    if (tid == 0 && next_t >= 0) {
      mbar_wait(empty, use);
      issue_chunk(next_t, next_part, st);
      if (++next_part == parts) next_part = 0, next_t = next_tile(next_t);
    }
    if (++st == S) st = 0, use ^= 1u;
  };
  // the work chunks: K's lo part, V^T's hi and lo parts (past head size
  // 64, K's lo part in V^T's hi part's place)
  unsigned char* work_klo = sm + L.work;
  unsigned char* work_vhi = work_klo + (kOut <= 64 ? kChunkBytes : 0);
  unsigned char* work_vlo = work_vhi + kChunkBytes;

  // S += Q K^T over the dims of K's chunk in stage `at` (Q's chunk
  // `part`): per 8 dims Q_lo K_hi (Q_lo from registers), Q_hi K_lo, Q_hi
  // K_hi, hi being the raw values; K's lo part in work_klo
  auto scores = [&](float (&s)[8][4], int part, int at) {
    uint32_t q_lo[kW / 8][4];
    const unsigned char* qc = sm + L.q + part * kChunkBytes;
#pragma unroll
    for (int ks = 0; ks < kW / 8; ++ks) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 8 * ks + c + 4 * (e >> 1);
        q_lo[ks][e] =
            bits(tf32_lo(*reinterpret_cast<const float*>(qc + chunk_off(lr + 8 * (e & 1), d))));
      }
    }
    const uint32_t q_at = base + L.q + part * kChunkBytes;
    const uint32_t k_at = base + L.stage + at * kChunkBytes;
    const uint32_t lo_at = base + L.work;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kW / 8; ++ks) {
      const uint32_t off = (ks / 4) * kBlockBytes32 + (ks % 4) * 32;
      tf32_rs_n64<0>(s, q_lo[ks], desc_k_major<128>(k_at + off));
      tf32_ss_n64<0>(s, desc_k_major<128>(q_at + off), desc_k_major<128>(lo_at + off));
      tf32_ss_n64<0>(s, desc_k_major<128>(q_at + off), desc_k_major<128>(k_at + off));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_frags(q_lo);
  };
  // O[:, 64 v..] += P V over the tile's 64 keys, V^T's parts in the work
  // chunks; P split in registers (hi: the raw probabilities)
  auto products = [&](auto vc, const float (&s)[8][4], const uint32_t (&p_lo)[8][4]) {
    constexpr int v = decltype(vc)::value;
    const uint32_t hi_at = smem_u32(work_vhi), lo_at = smem_u32(work_vlo);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t off = (kk / 4) * kVtBlock + (kk % 4) * 32;
      const uint32_t p_hi[4] = {bits(s[kk][0]), bits(s[kk][2]), bits(s[kk][1]), bits(s[kk][3])};
      if constexpr (kW == 32) {
        tf32_rs_n32<4 * v>(o, p_lo[kk], desc_k_major<128>(hi_at + off));
        tf32_rs_n32<4 * v>(o, p_hi, desc_k_major<128>(lo_at + off));
        tf32_rs_n32<4 * v>(o, p_hi, desc_k_major<128>(hi_at + off));
      } else {
        tf32_rs_n64<8 * v>(o, p_lo[kk], desc_k_major<128>(hi_at + off));
        tf32_rs_n64<8 * v>(o, p_hi, desc_k_major<128>(lo_at + off));
        tf32_rs_n64<8 * v>(o, p_hi, desc_k_major<128>(hi_at + off));
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
  };

  for (int t = next_tile(t_lo - 1); t >= 0; t = next_tile(t)) {
    const int key0 = t * kTileRows;
    float bias_v[8][4];
    if constexpr (kBias) {
      load_bias<float, 8, kSeg && kOut == 32>(bias_v, bb, p.sb, rows, Tq, Tk, key0, c, bias_vec,
                                              sg, seg_row);
    }
    // the accumulators are zeroed outside the products' stage
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    if constexpr (kOut <= 64) {
      // one K chunk and one V chunk (stages >= 2): both waited for, then
      // split in one pass between two barriers
      const int st_v = st + 1 == S ? 0 : st + 1;
      wait_chunk(t, 0, st, use);
      wait_chunk(t, 1, st_v, st + 1 == S ? use ^ 1u : use);
      __syncthreads();  // every warp is done with the work chunks
      split_lo<kW>(sm + L.stage + st * kChunkBytes, work_klo);
      split_transposed<kW>(sm + L.stage + st_v * kChunkBytes, work_vhi, work_vlo);
      fence_proxy_async();
      __syncthreads();  // K's lo part and V^T's parts are in
      scores(s, 0, st);
      release();
      release();
    } else {
      for (int part = 0; part < n_k; ++part) {
        wait_chunk(t, part, st, use);
        __syncthreads();  // every warp is done with the work chunks
        split_lo<kW>(sm + L.stage + st * kChunkBytes, work_klo);
        fence_proxy_async();
        __syncthreads();  // K's lo part is in
        scores(s, part, st);
        release();
      }
    }

    // the scores are whole: softmax, then P V on the block's columns
    softmax_tile<kBias, kSeg, kCausal>(s, bias_v, km, sg, seg_row, rows, key0, Tk, c, p.scale, m,
                                       l, o);
    uint32_t p_lo[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      p_lo[kk][0] = bits(tf32_lo(s[kk][0]));
      p_lo[kk][1] = bits(tf32_lo(s[kk][2]));
      p_lo[kk][2] = bits(tf32_lo(s[kk][1]));
      p_lo[kk][3] = bits(tf32_lo(s[kk][3]));
    }
    if constexpr (kOut <= 64) {
      products(std::integral_constant<int, 0>{}, s, p_lo);
    } else {
      auto v_part = [&](auto vc) {
        wait_chunk(t, n_k + decltype(vc)::value, st, use);
        __syncthreads();  // every warp is done with the work chunks
        split_transposed<kW>(sm + L.stage + st * kChunkBytes, work_vhi, work_vlo);
        fence_proxy_async();
        __syncthreads();  // V^T's parts are in; the raw chunk is no longer read
        release();
        products(vc, s, p_lo);
      };
      v_part(std::integral_constant<int, 0>{});
      if (n_v > 1) v_part(std::integral_constant<int, 1>{});
    }
    fence_regs(s);
    fence_frags(p_lo);
  }

  float sum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) sum[r] = quad_sum(l[r]);
  if (a.splits == 1) {
    float* ob = p.out + b * p.so.b + h * p.so.h;
    if (p.so.d == 1 && p.so.t % 4 == 0 && hs % 4 == 0 && aligned(ob, 16)) {
      // through the work chunks (free once every warp's products are done)
      // to 16-byte stores of whole rows; the 16-byte units of row r XOR
      // r % 8, so that the pair writes of a warp's 8 rows hit 32 banks
      __syncthreads();
      float* os = reinterpret_cast<float*>(work_klo);
#pragma unroll
      for (int n = 0; n < kOutN; ++n) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = lr + 8 * r, unit = (2 * n + (c >> 1)) ^ (row & 7);
          *reinterpret_cast<float2*>(os + row * kOut + 4 * unit + 2 * (c & 1)) =
              make_float2(o[n][2 * r] / sum[r], o[n][2 * r + 1] / sum[r]);
        }
      }
      __syncthreads();
      const int units = min(kOut, hs - col0) / 4, n_rows = min(kTileRows, Tq - q0);
      for (int e = tid; e < n_rows * units; e += kThreads) {
        const int row = e / units, u = e - row * units;
        *reinterpret_cast<float4*>(ob + (q0 + row) * p.so.t + col0 + 4 * u) =
            *reinterpret_cast<const float4*>(os + row * kOut + 4 * (u ^ (row & 7)));
      }
      return;
    }
#pragma unroll
    for (int n = 0; n < kOutN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = rows[e >> 1], d = col0 + 8 * n + 2 * c + (e & 1);
        if (i < Tq && d < hs) ob[i * p.so.t + d * p.so.d] = o[n][e] / sum[e >> 1];
      }
    }
    return;
  }
  // a partial: O unnormalised, and (from the first slice) each row's max and sum
  const long long n_rows = static_cast<long long>(a.B) * a.H * Tq;
  const long long row0 = ((static_cast<long long>(split) * a.B + b) * a.H + h) * Tq;
  float* po = a.part + row0 * hs;
#pragma unroll
  for (int n = 0; n < kOutN; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = rows[e >> 1], d = col0 + 8 * n + 2 * c + (e & 1);
      if (i < Tq && d < hs) po[static_cast<long long>(i) * hs + d] = o[n][e];
    }
  }
  if (col0 == 0 && c == 0) {
    float* pm = a.part + a.splits * n_rows * hs;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] < Tq) pm[row0 + rows[r]] = m[r], pm[a.splits * n_rows + row0 + rows[r]] = sum[r];
    }
  }
}

// The rows of a call whose keys were split: out = sum_s w_s O_s / sum_s w_s
// l_s with w_s = exp(m_s - max_s m_s), each row of each head once; a split
// that had no key tile (m = -inf) weighs 0.
__global__ void __launch_bounds__(256) merge_splits(const __grid_constant__ Fp32Args a) {
  const Params& p = a.p;
  const long long n_rows = static_cast<long long>(a.B) * a.H * p.Tq;
  const float* pm = a.part + a.splits * n_rows * p.hs;
  const float* pl = pm + a.splits * n_rows;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       e < n_rows * p.hs; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = e / p.hs;
    const int d = static_cast<int>(e - r * p.hs);
    float mx = -INFINITY;
    for (int s = 0; s < a.splits; ++s) mx = fmaxf(mx, pm[s * n_rows + r]);
    float num = 0.f, den = 0.f;
    for (int s = 0; s < a.splits; ++s) {
      const float ms = pm[s * n_rows + r];
      const float w = ms == -INFINITY ? 0.f : expf(ms - mx);
      den += w * pl[s * n_rows + r];
      num += w * a.part[(s * n_rows + r) * p.hs + d];
    }
    const int i = static_cast<int>(r % p.Tq);
    const long long bh = r / p.Tq;
    const int h = static_cast<int>(bh % a.H), b = static_cast<int>(bh / a.H);
    p.out[b * p.so.b + h * p.so.h + i * p.so.t + d * p.so.d] = num / den;
  }
}

// --------------------------------------------------------- host side

// cuTensorMapEncodeTiled, through the runtime (no link against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(f) : nullptr;
  }();
  return fn;
}

// A 4-d tensor map of (d0, d1, d2, d3) elements with element strides
// (1, s1, s2, s3), boxes of (box0, box1, 1, 1).  A dimension of extent 1
// takes the packed stride (its value is never used).  Returns a
// cudaError_t: invalid value where cuTensorMapEncodeTiled refuses the map.
inline int make_map(CUtensorMap* map, const void* ptr, bool is_bf16, const long long (&dim)[4],
                    const long long (&stride)[4], int box0, int box1, bool swizzle64) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int esize = is_bf16 ? 2 : 4;
  cuuint64_t dims[4], strides[3];
  long long packed = dim[0] * esize;
  for (int i = 0; i < 4; ++i) dims[i] = static_cast<cuuint64_t>(dim[i]);
  for (int i = 1; i < 4; ++i) {
    packed = (packed + 15) / 16 * 16;
    strides[i - 1] = static_cast<cuuint64_t>(dim[i] > 1 ? stride[i] * esize : packed);
    packed = static_cast<long long>(strides[i - 1]) * dim[i];
  }
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box0), static_cast<cuuint32_t>(box1), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, is_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
      const_cast<void*>(ptr), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// the map of one (B, H, T, D) bf16 view: boxes of (kCols dims, 64 rows)
inline int view_map(CUtensorMap* map, const bf16* ptr, const Strides& s, int B, int H, int T,
                    int hs, int dmax) {
  return make_map(map, ptr, true, {hs, T, H, B}, {s.d, s.t, s.h, s.b}, dmax < 64 ? dmax : 64,
                  kTileRows, dmax < 64);
}

template <int kMaxD, bool kBias, bool kSeg, typename BiasT>
int launch_bf16_padded(const ParamsT<bf16, BiasT>& p, int B, int H, int qkv_tma, int bias_tma,
                       int stages, int smem, cudaStream_t stream) {
  const bool sliced = p.hs > kMaxHs;  // kMaxD == kSliceD there
  const int slices = sliced ? (p.hs + kSliceD - 1) / kSliceD : 1;
  const int n_tiles = (p.Tk + kTileRows - 1) / kTileRows;
  if (stages < 1 || (!sliced && stages > n_tiles) || (sliced && bias_tma)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Bf16Smem L =
      bf16_smem(kMaxD, p.Tk, kBias && bias_tma ? 64 * 64 * sizeof(BiasT) : 0, stages, slices);
  if (smem != L.total || smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const long long z = static_cast<long long>(H) * slices;
  if (z > 65535) return static_cast<int>(cudaErrorInvalidValue);
  Bf16Args<BiasT> a{};
  a.p = p;
  a.qkv_tma = qkv_tma;
  a.bias_tma = kBias && bias_tma;
  a.bias_heads = p.sb.h != 0 ? H : 1;
  a.bias_rows = p.sb.b != 0 ? B : 1;
  a.stages = stages;
  int e = 0;
  if (qkv_tma) {
    if ((e = view_map(&a.qmap, p.q, p.sq, B, H, p.Tq, p.hs, kMaxD)) ||
        (e = view_map(&a.kmap, p.k, p.sk, B, H, p.Tk, p.hs, kMaxD)) ||
        (e = view_map(&a.vmap, p.v, p.sv, B, H, p.Tk, p.hs, kMaxD))) {
      return e;
    }
  }
  if (a.bias_tma) {
    e = make_map(&a.bmap, p.bias, std::is_same_v<BiasT, bf16>,
                 {p.Tk, p.Tq, a.bias_heads, a.bias_rows}, {p.sb.d, p.sb.t, p.sb.h, p.sb.b},
                 128 / static_cast<int>(sizeof(BiasT)), kTileRows, false);
    if (e) return e;
  }
  auto kernel = sliced               ? attention_kernel_bf16_sliced<kBias, kSeg, BiasT>
                : stages < n_tiles ? attention_kernel_bf16<kMaxD, kBias, kSeg, true, BiasT>
                                   : attention_kernel_bf16<kMaxD, kBias, kSeg, false, BiasT>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(B, (p.Tq + kTileRows - 1) / kTileRows, static_cast<unsigned>(z));
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Launches the bf16 core on `stream` for B rows and H heads as planned by
// the host (`qkv_tma`, `bias_tma`, `stages`, `smem`:
// ops/set_attention.py:bf16_plan); returns the launch's cudaError_t,
// invalid value where the plan is not the kernel's (its shared memory is
// not `bf16_smem`'s count, or passes 227 KB).  Head sizes past kMaxHs go
// to the sliced form.
template <bool kBias, bool kSeg, typename BiasT>
int launch_bf16(const ParamsT<bf16, BiasT>& p, int B, int H, int qkv_tma, int bias_tma,
                int stages, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.hs <= 32) {
    return launch_bf16_padded<32, kBias, kSeg>(p, B, H, qkv_tma, bias_tma, stages, smem, s);
  }
  if (p.hs <= 64) {
    return launch_bf16_padded<64, kBias, kSeg>(p, B, H, qkv_tma, bias_tma, stages, smem, s);
  }
  return launch_bf16_padded<kMaxHs, kBias, kSeg>(p, B, H, qkv_tma, bias_tma, stages, smem, s);
}

// the map of one (B, H, T, D) fp32 view: boxes of (32 dims, 64 rows), the
// 128-byte swizzle
inline int view_map_fp32(CUtensorMap* map, const float* ptr, const Strides& s, int B, int H,
                         int T, int hs) {
  return make_map(map, ptr, false, {hs, T, H, B}, {s.d, s.t, s.h, s.b}, 32, kTileRows, false);
}

template <int kOut, bool kBias, bool kSeg, bool kCausal>
int launch_fp32_padded(const Params& p, int B, int H, int qkv_tma, int stages, int splits,
                       int smem, float* part, cudaStream_t stream) {
  const int slices = (p.hs + kOut - 1) / kOut;
  const int n_tiles = (p.Tk + kTileRows - 1) / kTileRows;
  if (stages < (kOut <= 64 ? 2 : 1) || splits < 1 || splits > n_tiles ||
      (splits > 1) != (part != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Fp32Smem L = fp32_smem(kOut, p.hs, p.Tk, stages);
  if (smem != L.total || smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const long long z = static_cast<long long>(H) * slices * splits;
  if (z > 65535) return static_cast<int>(cudaErrorInvalidValue);
  Fp32Args a{};
  a.p = p;
  a.part = part;
  a.B = B;
  a.H = H;
  a.qkv_tma = qkv_tma;
  a.stages = stages;
  a.splits = splits;
  int e = 0;
  if (qkv_tma) {
    if ((e = view_map_fp32(&a.qmap, p.q, p.sq, B, H, p.Tq, p.hs)) ||
        (e = view_map_fp32(&a.kmap, p.k, p.sk, B, H, p.Tk, p.hs)) ||
        (e = view_map_fp32(&a.vmap, p.v, p.sv, B, H, p.Tk, p.hs))) {
      return e;
    }
  }
  auto kernel = attention_kernel_tf32<kOut, kBias, kSeg, kCausal>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(B, (p.Tq + kTileRows - 1) / kTileRows, static_cast<unsigned>(z));
  kernel<<<grid, kThreads, smem, stream>>>(a);
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess || splits == 1) return static_cast<int>(launched);
  const long long n = static_cast<long long>(B) * H * p.Tq * p.hs;
  merge_splits<<<static_cast<int>(n / 256 + 1 < 4096 ? n / 256 + 1 : 4096), 256, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Launches the fp32 core on `stream` for B rows and H heads as planned by
// the host (`qkv_tma`, `stages`, `splits`, `smem`:
// ops/set_attention.py:fp32_plan), with `part` the scratch of the split
// rows (splits > 1, (splits B H Tq (hs + 2)) floats) or null; returns the
// launch's cudaError_t, invalid value where the plan is not the kernel's
// (its shared memory is not `fp32_smem`'s count, or passes 227 KB).  Head
// sizes past kMaxHs go in slices of kSliceD output columns.
template <bool kBias, bool kSeg, bool kCausal = false>
int launch_fp32(const Params& p, int B, int H, int qkv_tma, int stages, int splits, int smem,
                float* part, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.hs <= 32) {
    return launch_fp32_padded<32, kBias, kSeg, kCausal>(p, B, H, qkv_tma, stages, splits, smem,
                                                        part, s);
  }
  if (p.hs <= 64) {
    return launch_fp32_padded<64, kBias, kSeg, kCausal>(p, B, H, qkv_tma, stages, splits, smem,
                                                        part, s);
  }
  return launch_fp32_padded<kSliceD, kBias, kSeg, kCausal>(p, B, H, qkv_tma, stages, splits, smem,
                                                           part, s);
}

}  // namespace set_attention_core

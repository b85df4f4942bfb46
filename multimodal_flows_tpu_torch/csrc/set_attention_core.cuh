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
// fp32 q/k/v: `attention_kernel`.  At the packed-row batch (B = 128 rows x
// T = 128 tokens, H = 4) one call moves 67 MB of q/k/v/out at C = 256,
// plus 33.5 MB of (B, H, T, T) bias in K2: about 30 us at 3.35 TB/s.  Its
// 2.15 GFLOP take 13 us at the TF32 tensor-core rate with three products
// per multiply.  The design:
//   - Tensor cores at fp32 accuracy: `mma.sync.m16n8k8` in TF32 with the
//     3xTF32 split.  Every fp32 operand is split once, when it is staged,
//     into hi = tf32(x) and lo = tf32(x - hi); each product is
//     lo*hi + hi*lo + hi*hi, summed in fp32 (error near 1e-6 at these
//     depths, against about 1e-3 for plain TF32), for Q K^T and for P V.
//   - A block is one (row b, head h, tile of 64 queries), 4 warps of 16
//     query rows, each keeping its q fragments (hi and lo) in registers.
//     K and V pass in tiles of 32 keys through a double-buffered ring in
//     shared memory, loaded with 16-byte `cp.async` where the strides allow
//     and 4-byte `cp.async` where they do not; rows padded to Dpad + 4
//     floats, so the fragment loads hit 32 banks.
//   - Softmax online (flash-style) in the accumulator layout; masked scores
//     are -1e9 (finite) as in the plain version.
//   - Key tiles are skipped where no query of a warp can attend to them,
//     and not loaded where no warp of the block can, by bit masks over
//     windows of 32 tiles (1024 keys) made once a block and kept in shared
//     memory (`TileNeeds`); past 1024 keys (kLong) the loop moves from one
//     window to the next.  Under segments: each
//     warp knows the min and max segment id of its queries, each key tile
//     those of its keys, both without the pads' id -1, which is a flag of
//     its own; a tile is skipped when the intervals are disjoint and they
//     do not both hold pads.  Under kCausal (GPT's full forward): a tile is
//     skipped when its first key lies past the warp's last query, and a
//     warp whose rows all lie at or past Tq skips every tile; no bias is
//     read, the causal term is added where the bias form adds the bias.
//     Either way every pair of a skipped tile would score -1e9 plus a small
//     term, so each of its probabilities is exactly 0 in fp32 for a query
//     that keeps one unmasked key of its own: every query does, itself
//     (Tq == Tk), and the tile holding it is never skipped.  At GPT's
//     T = 152 the causal form computes 30 of the 60 warp tiles of the bias
//     form and loads 11 of its 15 block tiles.  Its time follows the block
//     tiles (the staging, the 3xTF32 split and the barriers of each), not
//     the warp products; its blocks start with the last query tile, the
//     longest (4% faster than in order on the card).
//   - The bias (kBias) is read per accumulator fragment from global memory.
//   - Head sizes past 128 (`attention_kernel_sliced`): the q fragments and
//     the accumulator of a whole head do not fit in registers, so a block
//     takes one slice of 128 output columns, its 64 query rows kept in
//     shared memory and split on use, each key tile streamed as K's
//     128-wide passes then V's slice; S is recomputed by every slice.
//
// bf16 q/k/v (the encoders' compute_dtype="bfloat16"): `attention_kernel_bf16`.
// What bounds it here is not its bytes (33.5 MB at C = 256 without a bias,
// 10 us) but the chain of round trips of a small block: with Tk <= 256 a
// block has at most 8 key tiles of 32, and the earlier mma.sync design
// waited for Q, then for each K/V tile (`cp.async.wait_group 0` and a
// barrier), then read the bias of the tile from global memory into
// registers: 4.4-6.3x above its byte bound, slower than one
// `scaled_dot_product_attention` call.  The design:
//   - One block is (row b, 64 queries, head h): one warpgroup of 4 warps,
//     the 64 rows of a `wgmma` tile.  Its loads are in flight together: the
//     first thread issues TMA loads (`cp.async.bulk.tensor.4d` with a
//     tensor map) of Q and of the K/V tiles of 64 keys, with the bias block
//     beside each tile, each key tile completing on its own `mbarrier`,
//     while the threads read the key mask and the segment ids.  With
//     Tk <= 256 and head size <= 128 the whole row fits in shared memory
//     (at most 217 KB), so the ring of key tiles never wraps and no tile
//     waits for another's consumer (kRing false: the layout and the loop
//     of the kernel before key rings).  The block computes as tiles land.
//   - Past 256 keys (kRing) the key tiles pass through a ring of S stages
//     (2-4, as many as fit), each with a `full` and an `empty` mbarrier:
//     thread 0 loads the tile S needed tiles on into a stage once every
//     thread has arrived on its `empty` barrier; the bias block of a tile
//     travels in its stage.
//   - Head sizes past 128 (`attention_kernel_bf16_sliced`): a block takes
//     one slice of 128 output columns, as in the fp32 core; its query rows
//     stay in shared memory as chunks of 64 x 128, and each needed key tile
//     passes through a ring of chunks of 64 keys x 128 (K's passes, then
//     V's slice); the bias is read per fragment.
//   - Under segments only the key tiles whose interval of ids meets the
//     block's 64 queries (the test above, on the warpgroup's rows) are
//     loaded, once the ids are in: measured against loading every tile at
//     once, 2-3% faster for K1 and level for K2 at the packed rows.
//   - Q, K and V land in the swizzled K-major layout that `wgmma` reads
//     (128-byte swizzle, 64-byte at head size <= 32, head dims past the
//     head size zero-filled by the tensor map's bounds).  S = Q K^T is
//     `wgmma.m64n64k16` with both operands in shared memory; P V is
//     `wgmma.m64nDk16` with P from registers (rounded to bf16 in the
//     accumulator-to-A layout, as before) and V in shared memory read
//     MN-major through the transpose bit.  Scores and softmax stay fp32.
//   - The bias block of a key tile (64 queries x 64 keys) lands by TMA
//     in boxes of 128-byte rows, swizzled, where the bias's key stride is
//     1 and its row stride and base meet TMA's 16-byte rules (the
//     co-occurrence (B,H,T,T) bias and the pair biases at T % 4 == 0; a
//     zero stride is a dimension of size 1); the fragments read it from
//     there.  Other biases (T = 150: rows of 600 bytes) are read per
//     fragment from global memory, as in the fp32 path.
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
// ids of a row are staged whole (8 Tk bytes: 32 KB at Tk = 4096), and in
// slices the query rows of the whole head (fp32 256 (hs + 4) bytes, bf16
// 128 hs); with the tiles that leaves Tk up to about 16,000 at head size
// 128 and head sizes up to about 700 at Tk = 4096.  The launch refuses a
// call past it (invalid value), and the host plans raise first, naming it.
// Offsets are 64-bit; the grid bounds Tq by 65,535 query tiles and H x
// slices by 65,535.

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
constexpr int kRowsPerWarp = 16;               // one m16 tile
constexpr int kQTile = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kKTile = 32;                     // keys per staged tile
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

// x = hi + lo with both in TF32 (lo keeps the next 11 bits)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b at fp32 accuracy: the small products first, then hi * hi
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], const float* b_hi,
                                           const float* b_lo, int b1_offset) {
  const uint32_t h0 = __float_as_uint(b_hi[0]), h1 = __float_as_uint(b_hi[b1_offset]);
  mma_tf32(d, a_lo, h0, h1);
  mma_tf32(d, a_hi, __float_as_uint(b_lo[0]), __float_as_uint(b_lo[b1_offset]));
  mma_tf32(d, a_hi, h0, h1);
}

// kBytes of global memory to shared memory, or kBytes of zeros
template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// log2 of the power of two >= the units (of kUnit floats) in a padded row;
// threads map to (row, unit) by shifts, with no divide
template <int kUnit>
__device__ __forceinline__ int unit_shift(int dpad) {
  return 32 - __clz(dpad / kUnit - 1);
}

// Issue the copy of rows j0..j0+kRows-1 of one (T, D) view into a tile of
// `stride` floats a row, dims >= hs and rows >= T as zeros.
template <int kRows, int kUnit>
__device__ __forceinline__ void stage_rows(float* dst, int stride, const float* src,
                                           long long st, long long sd, int j0, int T, int hs,
                                           int dpad) {
  const int shift = unit_shift<kUnit>(dpad);
  const int d = (threadIdx.x & ((1 << shift) - 1)) * kUnit;
  if (d >= dpad) return;
  for (int r = threadIdx.x >> shift; r < kRows; r += kThreads >> shift) {
    const int j = j0 + r;
    const bool ok = d < hs && j < T;
    cp_async<4 * kUnit>(dst + r * stride + d, ok ? src + j * st + d * sd : src, ok);
  }
}

// Split a staged tile in place into its TF32 hi part, writing lo beside it.
__device__ __forceinline__ void split_tile(float* hi, float* lo, int stride, int dpad) {
  const int shift = unit_shift<4>(dpad);
  const int d = (threadIdx.x & ((1 << shift) - 1)) * 4;
  if (d >= dpad) return;
  for (int r = threadIdx.x >> shift; r < kKTile; r += kThreads >> shift) {
    float4* ph = reinterpret_cast<float4*>(hi + r * stride + d);
    const float4 x = *ph;
    uint32_t h[4], l[4];
    split(x.x, h[0], l[0]);
    split(x.y, h[1], l[1]);
    split(x.z, h[2], l[2]);
    split(x.w, h[3], l[3]);
    *ph = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                      __uint_as_float(h[3]));
    *reinterpret_cast<float4*>(lo + r * stride + d) =
        make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                    __uint_as_float(l[3]));
  }
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

// The key tiles of 32 that the fp32 core's warps need, as bit masks over
// a window of 32 tiles (1024 keys; one window at Tk <= 1024, so the loop
// keeps two masks in registers as it did when Tk was capped at 256): every
// tile; under segments (kSeg) the tiles whose interval meets the warp's
// (`need_warp`) or any warp's (`need_block`); under kCausal the tiles up to
// the warp's (the block's) last query row.  Under segments `init` (called
// by every thread once the segment ids are in shared memory) writes the
// masks of every window to `words` in shared memory, `tile_ints(Tk)` ints
// with the intervals they are made from: a window's masks are then two
// loads.
__host__ __device__ constexpr int tile_ints(int Tk) {
  return 3 * ((Tk + kKTile - 1) / kKTile) + 3 * kWarps +
         (1 + kWarps) * ((Tk + 32 * kKTile - 1) / (32 * kKTile));
}

// the bits of tiles 0..k of a window (none for k < 0)
__device__ __forceinline__ uint32_t tiles_upto(int k) {
  return k < 0 ? 0u : k >= 31 ? 0xffffffffu : (2u << k) - 1u;
}

template <bool kSeg, bool kCausal>
struct TileNeeds {
  const uint32_t* words;  // window w: the block's at w, warp v's at (1 + v) n_windows + w
  int n_tiles, n_windows;

  __device__ __forceinline__ void init(const int* sg, int* t_ints, int Tq, int Tk, int q0) {
    n_tiles = (Tk + kKTile - 1) / kKTile;
    n_windows = (n_tiles + 31) / 32;
    const int n = n_tiles + kWarps;
    uint32_t* w_out = reinterpret_cast<uint32_t*>(t_ints + 3 * n);
    words = w_out;
    if constexpr (kSeg) {
      int* lo = t_ints;
      int* hi = t_ints + n;
      int* pad = t_ints + 2 * n;
      tile_intervals<kKTile>(sg, Tk, lo, hi, pad);
      const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
      int a, z;
      bool p;
      rows_interval(sg, Tq, q0 + warp * kRowsPerWarp + lane, lane < kRowsPerWarp, a, z, p);
      if (lane == 0) lo[n_tiles + warp] = a, hi[n_tiles + warp] = z, pad[n_tiles + warp] = p;
      __syncthreads();
      for (int i = threadIdx.x; i < (1 + kWarps) * n_windows; i += kThreads) {
        const int who = i / n_windows, first = 32 * (i - who * n_windows);
        uint32_t word = 0;
        for (int j = 0; j < 32 && first + j < n_tiles; ++j) {
          const int t = first + j;
          bool need = false;
          for (int v = 0; v < kWarps; ++v) {
            const int x = n_tiles + v;
            if ((who == 0 || who == 1 + v) && meets(lo[x], hi[x], pad[x], lo[t], hi[t], pad[t])) {
              need = true;
            }
          }
          word |= static_cast<uint32_t>(need) << j;
        }
        w_out[i] = word;
      }
      __syncthreads();
    }
  }

  // the masks of the window of tiles first.. first + 31
  __device__ __forceinline__ void window(int first, int q0, int Tq, int warp, uint32_t& need_warp,
                                         uint32_t& need_block) const {
    if constexpr (kCausal) {
      const int row = q0 + warp * kRowsPerWarp;
      const int last = min(row + kRowsPerWarp, Tq) - 1;
      need_warp = row < Tq ? tiles_upto(last / kKTile - first) : 0u;
      need_block = tiles_upto((min(q0 + kQTile, Tq) - 1) / kKTile - first);
    } else if constexpr (kSeg) {
      need_warp = words[(1 + warp) * n_windows + first / 32];
      need_block = words[first / 32];
    } else {
      need_warp = need_block = tiles_upto(n_tiles - first - 1);
    }
  }
};

// The bias of the warp's accumulator fragments for the key tile at key0
// (kNB blocks of 8 keys): two adjacent keys a thread, read as one pair
// where `vec` (key stride 1, rows aligned to two values), 0 past Tq or Tk.
template <typename BiasT, int kNB>
__device__ __forceinline__ void load_bias(float (&bias_v)[kNB][4], const BiasT* bb,
                                          const Strides& sb, const int (&rows)[2], int Tq,
                                          int Tk, int key0, int c, bool vec) {
#pragma unroll
  for (int n = 0; n < kNB; ++n) {
    const int j = key0 + 8 * n + 2 * c;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x0 = 0.f, x1 = 0.f;
      if (rows[r] < Tq) {
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

// One block: row b = blockIdx.x, query tile blockIdx.y, head h = blockIdx.z.
// kMaxD bounds the padded head size (32, 64 or 128) and sizes the register
// fragments.  Fragment layouts are those of mma.m16n8k8 (g = lane / 4,
// c = lane % 4): A holds rows g, g + 8 and columns c, c + 4; B rows (k)
// c, c + 4 and column g; the accumulator rows g, g + 8 and columns 2c,
// 2c + 1.  For P V the key order inside each 8-key step is permuted so
// that A column c is key 2c and column c + 4 key 2c + 1: P then goes from
// the score accumulator to the A operand with no shuffle, and V's B
// fragment reads keys 2c and 2c + 1.
template <int kMaxD, bool kBias, bool kSeg, bool kCausal, bool kLong>
__device__ __forceinline__ void attention_block(const Params p) {
  constexpr int kSteps = kMaxD / 8;  // 8-wide steps over the head dims
  extern __shared__ __align__(16) float smem[];

  const int hs = p.hs, Tq = p.Tq, Tk = p.Tk;
  const int dpad = (hs + 7) & ~7;
  const int nk = dpad / 8;
  const int stride = dpad + 4;  // == 4 mod 8: conflict-free fragment loads
  const int tile_floats = kKTile * stride;
  float* kbuf = smem;                    // 2 tiles: K as copied, then its hi part
  float* vbuf = kbuf + 2 * tile_floats;  // 2 tiles: V
  float* klo = vbuf + 2 * tile_floats;   // lo part of the current K tile
  float* vlo = klo + tile_floats;        // lo part of the current V tile
  float* qs = klo;                       // before the first tile: the 64 query rows
  float* km = vlo + tile_floats;         // Tk key mask
  int* sg = reinterpret_cast<int*>(km + Tk);  // Tk segment ids
  int* tiles = sg + Tk;                  // the segment intervals (TileNeeds)

  const int b = blockIdx.x;
  const int h = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int c = lane & 3;

  const float* qb = p.q + b * p.sq.b + h * p.sq.h;
  const float* kb = p.k + b * p.sk.b + h * p.sk.h;
  const float* vb = p.v + b * p.sv.b + h * p.sv.h;
  const float* bb = kBias ? p.bias + b * p.sb.b + h * p.sb.h : nullptr;
  float* ob = p.out + b * p.so.b + h * p.so.h;

  // the query tile, the key mask and the segment ids, all in flight at once
  // (the causal form takes its longest query tiles, the last, first)
  const int q0 = (kCausal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kQTile;
  if (p.sq.d == 1 && p.sq.t % 4 == 0 && hs % 4 == 0 && aligned(qb, 16)) {
    stage_rows<kQTile, 4>(qs, stride, qb, p.sq.t, p.sq.d, q0, Tq, hs, dpad);
  } else {
    stage_rows<kQTile, 1>(qs, stride, qb, p.sq.t, p.sq.d, q0, Tq, hs, dpad);
  }
  for (int j = tid; j < Tk; j += kThreads) {
    const long long at = static_cast<long long>(b) * Tk + j;
    if (p.key_mask) cp_async<4>(km + j, p.key_mask + at, true);
    else km[j] = 0.f;
    if (kSeg) cp_async<4>(reinterpret_cast<float*>(sg + j),
                          reinterpret_cast<const float*>(p.segments + at), true);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // the key tiles this warp, and the block, need: masks of a window of 32
  // (made before the q fragments are held in registers)
  TileNeeds<kSeg, kCausal> need;
  need.init(sg, tiles, Tq, Tk, q0);
  int first = 0;  // the window's first tile
  uint32_t need_warp, todo;
  need.window(first, q0, Tq, warp, need_warp, todo);

  // the warp's q fragments, split once
  uint32_t q_hi[kSteps][4], q_lo[kSteps][4];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = warp * kRowsPerWarp + g + ((e & 1) ? 8 : 0);
      const int d = 8 * ks + c + ((e & 2) ? 4 : 0);
      split(ks < nk ? qs[r * stride + d] : 0.f, q_hi[ks][e], q_lo[ks][e]);
    }
  }


  const bool k_vec = p.sk.d == 1 && p.sk.t % 4 == 0 && hs % 4 == 0 && aligned(kb, 16);
  const bool v_vec = p.sv.d == 1 && p.sv.t % 4 == 0 && hs % 4 == 0 && aligned(vb, 16);
  auto stage = [&](int t, int buf) {
    float* kd = kbuf + buf * tile_floats;
    float* vd = vbuf + buf * tile_floats;
    if (k_vec) stage_rows<kKTile, 4>(kd, stride, kb, p.sk.t, p.sk.d, t * kKTile, Tk, hs, dpad);
    else stage_rows<kKTile, 1>(kd, stride, kb, p.sk.t, p.sk.d, t * kKTile, Tk, hs, dpad);
    if (v_vec) stage_rows<kKTile, 4>(vd, stride, vb, p.sv.t, p.sv.d, t * kKTile, Tk, hs, dpad);
    else stage_rows<kKTile, 1>(vd, stride, vb, p.sv.t, p.sv.d, t * kKTile, Tk, hs, dpad);
    cp_async_commit();
  };

  __syncthreads();  // every warp holds its q fragments: qs may be overwritten
  // some window is not empty: warp 0's first row needs its own key (in
  // the first window where Tk <= 1024, !kLong)
  while (kLong && !todo) {
    first += 32;
    need.window(first, q0, Tq, warp, need_warp, todo);
  }
  int t = first + __ffs(todo) - 1;
  todo &= todo - 1;
  stage(t, 0);

  const int row0 = q0 + warp * kRowsPerWarp + g;
  const int rows[2] = {row0, row0 + 8};
  int seg_row[2] = {0, 0};
  if constexpr (kSeg) {
#pragma unroll
    for (int r = 0; r < 2; ++r) seg_row[r] = rows[r] < Tq ? sg[rows[r]] : -1;
  }
  const bool bias_vec = kBias && p.sb.d == 1 && p.sb.t % 2 == 0 && aligned(bb, 8);

  float o[kSteps][4];
#pragma unroll
  for (int n = 0; n < kSteps; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of each row
  float l[2] = {0.f, 0.f};              // this thread's part of each row's sum

  for (int buf = 0;; buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // tile t landed; every warp is done with the previous tile
    const bool mine = (need_warp >> (t - first)) & 1u;
    while (kLong && !todo && first + 32 < need.n_tiles) {
      first += 32;
      need.window(first, q0, Tq, warp, need_warp, todo);
    }
    const int next = todo ? first + __ffs(todo) - 1 : -1;
    if (next >= 0) {
      todo &= todo - 1;
      stage(next, buf ^ 1);
    }
    float* kh = kbuf + buf * tile_floats;
    float* vh = vbuf + buf * tile_floats;
    split_tile(kh, klo, stride, dpad);
    split_tile(vh, vlo, stride, dpad);
    __syncthreads();

    if (mine) {
      const int key0 = t * kKTile;
      float bias_v[4][4];
      if constexpr (kBias) load_bias(bias_v, bb, p.sb, rows, Tq, Tk, key0, c, bias_vec);

      // scores of the warp's 16 rows against the tile's 32 keys
      float s[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        if (ks < nk) {
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int off = (8 * n + g) * stride + 8 * ks + c;
            mma_3xtf32(s[n], q_hi[ks], q_lo[ks], kh + off, klo + off, 4);
          }
        }
      }

      softmax_tile<kBias, kSeg, kCausal>(s, bias_v, km, sg, seg_row, rows, key0, Tk, c, p.scale,
                                         m, l, o);

      // P V: 8 keys at a time, P straight from the score accumulator
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t a_hi[4], a_lo[4];
        split(s[kk][0], a_hi[0], a_lo[0]);
        split(s[kk][2], a_hi[1], a_lo[1]);
        split(s[kk][1], a_hi[2], a_lo[2]);
        split(s[kk][3], a_hi[3], a_lo[3]);
        const int base = (8 * kk + 2 * c) * stride + g;
#pragma unroll
        for (int n = 0; n < kSteps; ++n) {
          if (n < nk) mma_3xtf32(o[n], a_hi, a_lo, vh + base + 8 * n, vlo + base + 8 * n, stride);
        }
      }
    }
    if (next < 0) break;
    t = next;
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = 1.f / quad_sum(l[r]);
#pragma unroll
  for (int n = 0; n < kSteps; ++n) {
    if (n < nk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = rows[e >> 1];
        const int d = 8 * n + 2 * c + (e & 1);
        if (i < Tq && d < hs) ob[i * p.so.t + d * p.so.d] = o[n][e] * inv[e >> 1];
      }
    }
  }
}

template <int kMaxD, bool kBias, bool kSeg, bool kCausal, bool kLong>
__global__ void __launch_bounds__(kThreads) attention_kernel(const Params p) {
  attention_block<kMaxD, kBias, kSeg, kCausal, kLong>(p);
}

// Head size 33-64 keeps 3 blocks an SM (<= 168 registers a thread), the
// allocation it had before the need masks moved to windows: left to
// itself, ptxas gave the bias + segments form 178-190 registers and 2
// blocks, 14-20% slower at the packed rows.  (A bound of 1 block on the
// other head sizes changes their allocation too, so they keep none.)
template <bool kBias, bool kSeg, bool kCausal, bool kLong>
__global__ void __launch_bounds__(kThreads, 3) attention_kernel_64(const Params p) {
  attention_block<64, kBias, kSeg, kCausal, kLong>(p);
}

// Rows j0..j0+kRows-1 of a (T, D) view of any width into rows of `stride`
// floats, dims >= hs (to dpad) and rows >= T as zeros; the fp32 sliced
// form's query rows, staged once a block.
template <int kRows, int kUnit>
__device__ __forceinline__ void stage_rows_any(float* dst, int stride, const float* src,
                                               long long st, long long sd, int j0, int T, int hs,
                                               int dpad) {
  const int units = dpad / kUnit;
  for (int e = threadIdx.x; e < kRows * units; e += kThreads) {
    const int r = e / units, d = (e - r * units) * kUnit, j = j0 + r;
    const bool ok = d < hs && j < T;
    cp_async<4 * kUnit>(dst + r * stride + d, ok ? src + j * st + d * sd : src, ok);
  }
}

// The fp32 sliced form, head sizes past kMaxHs.  The q fragments (hi and
// lo) and the output accumulator of a whole head do not fit in registers
// there (about 2 hs + hs / 2 a thread), so a block takes one slice of
// kSliceD output columns: blockIdx.z = h * n_slices + slice.  Its 64 query
// rows stay in shared memory as fp32 (64 (hs + 4) floats: 132 KB at head
// size 512) and are split on use.  Each key tile it needs streams through
// the double buffer as n_slices + 1 chunks of 32 keys x kSliceD columns:
// K in kSliceD-wide passes (S = Q K^T accumulated over them), then V's
// slice for P V.  S is recomputed by every slice of a head: the price of
// keeping the registers of the whole-head form (no spills) at any width.
// Skipping, masks, bias, causal term and softmax are those of
// `attention_kernel`.
template <bool kBias, bool kSeg, bool kCausal>
__global__ void __launch_bounds__(kThreads) attention_kernel_sliced(const Params p) {
  constexpr int kSteps = kSliceD / 8;
  constexpr int kStride = kSliceD + 4;  // == 4 mod 8, as `stride` above
  constexpr int kChunk = kKTile * kStride;
  extern __shared__ __align__(16) float smem[];

  const int hs = p.hs, Tq = p.Tq, Tk = p.Tk;
  const int n_slices = (hs + kSliceD - 1) / kSliceD;  // also the passes of Q K^T
  const int dpad = (hs + 7) & ~7;
  const int qstride = dpad + 4;
  float* qs = smem;                         // the 64 query rows, whole head
  float* cbuf = qs + kQTile * qstride;      // 2 chunks, as copied, then their hi part
  float* clo = cbuf + 2 * kChunk;           // lo part of the current chunk
  float* km = clo + kChunk;                 // Tk key mask
  int* sg = reinterpret_cast<int*>(km + Tk);  // Tk segment ids
  int* tiles = sg + Tk;                     // the segment intervals (TileNeeds)

  const int b = blockIdx.x;
  const int h = blockIdx.z / n_slices;
  const int col0 = (blockIdx.z - h * n_slices) * kSliceD;  // the slice's first column
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int c = lane & 3;

  const float* qb = p.q + b * p.sq.b + h * p.sq.h;
  const float* kb = p.k + b * p.sk.b + h * p.sk.h;
  const float* vb = p.v + b * p.sv.b + h * p.sv.h;
  const float* bb = kBias ? p.bias + b * p.sb.b + h * p.sb.h : nullptr;
  float* ob = p.out + b * p.so.b + h * p.so.h;

  const int q0 = (kCausal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kQTile;
  if (p.sq.d == 1 && p.sq.t % 4 == 0 && hs % 4 == 0 && aligned(qb, 16)) {
    stage_rows_any<kQTile, 4>(qs, qstride, qb, p.sq.t, p.sq.d, q0, Tq, hs, dpad);
  } else {
    stage_rows_any<kQTile, 1>(qs, qstride, qb, p.sq.t, p.sq.d, q0, Tq, hs, dpad);
  }
  for (int j = tid; j < Tk; j += kThreads) {
    const long long at = static_cast<long long>(b) * Tk + j;
    if (p.key_mask) cp_async<4>(km + j, p.key_mask + at, true);
    else km[j] = 0.f;
    if (kSeg) cp_async<4>(reinterpret_cast<float*>(sg + j),
                          reinterpret_cast<const float*>(p.segments + at), true);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  TileNeeds<kSeg, kCausal> need;
  need.init(sg, tiles, Tq, Tk, q0);
  int first = 0;  // the window of the tile in turn
  uint32_t need_warp, todo;
  need.window(first, q0, Tq, warp, need_warp, todo);

  // chunk `part` of key tile t: K's columns kSliceD * part.. for part <
  // n_slices, then V's slice; its first column and padded width
  auto chunk_cols = [&](int part, int& c0, int& wpad) {
    c0 = part < n_slices ? part * kSliceD : col0;
    wpad = (min(kSliceD, hs - c0) + 7) & ~7;
  };
  const bool k_vec = p.sk.d == 1 && p.sk.t % 4 == 0 && hs % 4 == 0 && aligned(kb, 16);
  const bool v_vec = p.sv.d == 1 && p.sv.t % 4 == 0 && hs % 4 == 0 && aligned(vb, 16);
  auto stage = [&](int t, int part, int buf) {
    int c0, wpad;
    chunk_cols(part, c0, wpad);
    const bool is_k = part < n_slices;
    const Strides& sx = is_k ? p.sk : p.sv;
    const float* src = (is_k ? kb : vb) + c0 * sx.d;
    const int w = min(kSliceD, hs - c0);
    float* d = cbuf + buf * kChunk;
    const int j0 = t * kKTile;
    if (is_k ? k_vec : v_vec) stage_rows<kKTile, 4>(d, kStride, src, sx.t, sx.d, j0, Tk, w, wpad);
    else stage_rows<kKTile, 1>(d, kStride, src, sx.t, sx.d, j0, Tk, w, wpad);
    cp_async_commit();
  };

  while (!todo) {  // some window is not empty: warp 0's first row needs its own key
    first += 32;
    need.window(first, q0, Tq, warp, need_warp, todo);
  }
  int t = first + __ffs(todo) - 1, part = 0;
  todo &= todo - 1;
  bool mine = (need_warp >> (t - first)) & 1u;
  stage(t, 0, 0);

  const int row0 = q0 + warp * kRowsPerWarp + g;
  const int rows[2] = {row0, row0 + 8};
  int seg_row[2] = {0, 0};
  if constexpr (kSeg) {
#pragma unroll
    for (int r = 0; r < 2; ++r) seg_row[r] = rows[r] < Tq ? sg[rows[r]] : -1;
  }
  const bool bias_vec = kBias && p.sb.d == 1 && p.sb.t % 2 == 0 && aligned(bb, 8);
  const int nv = (min(kSliceD, hs - col0) + 7) / 8;  // 8-wide output blocks of the slice

  float o[kSteps][4];
#pragma unroll
  for (int n = 0; n < kSteps; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float s[4][4];

  for (int buf = 0;; buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // the chunk landed; every warp is done with the previous one
    const bool needed = mine;  // by this warp, the tile of this chunk
    int next_t = t, next_part = part + 1;
    if (next_part > n_slices) {
      while (!todo && first + 32 < need.n_tiles) {
        first += 32;
        need.window(first, q0, Tq, warp, need_warp, todo);
      }
      next_t = todo ? first + __ffs(todo) - 1 : -1, next_part = 0;
      todo &= todo - 1;
      if (next_t >= 0) mine = (need_warp >> (next_t - first)) & 1u;
    }
    if (next_t >= 0) stage(next_t, next_part, buf ^ 1);
    int c0, wpad;
    chunk_cols(part, c0, wpad);
    float* ch = cbuf + buf * kChunk;
    split_tile(ch, clo, kStride, wpad);
    __syncthreads();

    if (needed) {
      if (part < n_slices) {  // S += Q[:, c0..] K[keys, c0..]^T, q split on use
        if (part == 0) {
#pragma unroll
          for (int n = 0; n < 4; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
        }
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks) {
          if (ks < wpad / 8) {
            uint32_t a_hi[4], a_lo[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = warp * kRowsPerWarp + g + ((e & 1) ? 8 : 0);
              const int d = c0 + 8 * ks + c + ((e & 2) ? 4 : 0);
              split(qs[r * qstride + d], a_hi[e], a_lo[e]);
            }
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              const int off = (8 * n + g) * kStride + 8 * ks + c;
              mma_3xtf32(s[n], a_hi, a_lo, ch + off, clo + off, 4);
            }
          }
        }
      } else {  // the scores are whole: softmax, then P V on the slice
        const int key0 = t * kKTile;
        float bias_v[4][4];
        if constexpr (kBias) load_bias(bias_v, bb, p.sb, rows, Tq, Tk, key0, c, bias_vec);
        softmax_tile<kBias, kSeg, kCausal>(s, bias_v, km, sg, seg_row, rows, key0, Tk, c,
                                           p.scale, m, l, o);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t a_hi[4], a_lo[4];
          split(s[kk][0], a_hi[0], a_lo[0]);
          split(s[kk][2], a_hi[1], a_lo[1]);
          split(s[kk][1], a_hi[2], a_lo[2]);
          split(s[kk][3], a_hi[3], a_lo[3]);
          const int base = (8 * kk + 2 * c) * kStride + g;
#pragma unroll
          for (int n = 0; n < kSteps; ++n) {
            if (n < nv) {
              mma_3xtf32(o[n], a_hi, a_lo, ch + base + 8 * n, clo + base + 8 * n, kStride);
            }
          }
        }
      }
    }
    if (next_t < 0) break;
    t = next_t, part = next_part;
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = 1.f / quad_sum(l[r]);
  const int width = min(kSliceD, hs - col0);
#pragma unroll
  for (int n = 0; n < kSteps; ++n) {
    if (n < nv) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = rows[e >> 1];
        const int d = 8 * n + 2 * c + (e & 1);
        if (i < Tq && d < width) ob[i * p.so.t + (col0 + d) * p.so.d] = o[n][e] * inv[e >> 1];
      }
    }
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

// The key tiles of 64 that the bf16 block's 64 query rows at q0 need:
// every tile, or under segments (kSeg) the tiles whose interval meets the
// rows' (the test of `TileNeeds`, on the warpgroup's rows).  Every thread
// calls `init` once the segment ids are in shared memory, and gets the same
// answers; `scratch` holds bf16_scratch_ints(Tk) ints.
template <bool kSeg>
struct BlockNeeds {
  const int* lo;
  const int* hi;
  const int* pad;
  int n_tiles, rlo, rhi;
  bool rpad;

  __device__ __forceinline__ void init(const int* sg, int* scratch, int Tq, int Tk, int q0) {
    n_tiles = (Tk + kTileRows - 1) / kTileRows;
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
    else return true;
  }

  // the first needed tile after t, -1 past the last
  __device__ __forceinline__ int next(int t) const {
    for (int u = t + 1; u < n_tiles; ++u) {
      if (needs(u)) return u;
    }
    return -1;
  }

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

// The fp32 core's shared memory in bytes: the K/V ring and the query
// rows (whole head at head sizes <= kMaxHs: 6 tiles of 32 padded rows; in
// slices: 64 query rows of the whole head and 3 chunks of kSliceD
// columns), the key mask, the segment ids and their tile intervals.
// ops/set_attention.py:fp32_smem_bytes computes the same number.
__host__ __device__ inline long long fp32_smem(int hs, int Tk) {
  const long long dpad = (hs + 7) & ~7;
  const long long floats = hs <= kMaxHs ? 6LL * kKTile * (dpad + 4)
                                        : kQTile * (dpad + 4) + 3LL * kKTile * (kSliceD + 4);
  return 4 * (floats + Tk) + 4LL * Tk + 4LL * tile_ints(Tk);
}

template <typename Kernel>
int launch_fp32_kernel(Kernel kernel, const Params& p, dim3 grid, cudaStream_t stream) {
  const long long smem = fp32_smem(p.hs, p.Tk);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, kThreads, static_cast<size_t>(smem), stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Launches the fp32 core on `stream` for B rows and H heads; returns the
// launch's cudaError_t, invalid value where the shared memory
// (`fp32_smem`) passes the 227 KB a block has.  Head sizes past kMaxHs go
// to the sliced form, ceil(hs / kSliceD) blocks a (row, query tile, head).
template <bool kBias, bool kSeg, bool kCausal = false>
int launch(const Params& p, int B, int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int q_tiles = (p.Tq + kQTile - 1) / kQTile;
  const dim3 grid(B, q_tiles, H);
  if (p.hs <= kMaxHs && p.Tk > 32 * kKTile) {  // more than one window of key tiles
    if (p.hs <= 32) return launch_fp32_kernel(attention_kernel<32, kBias, kSeg, kCausal, true>, p,
                                              grid, s);
    if (p.hs <= 64) return launch_fp32_kernel(attention_kernel_64<kBias, kSeg, kCausal, true>, p,
                                              grid, s);
    return launch_fp32_kernel(attention_kernel<kMaxHs, kBias, kSeg, kCausal, true>, p, grid, s);
  }
  if (p.hs <= 32) return launch_fp32_kernel(attention_kernel<32, kBias, kSeg, kCausal, false>, p,
                                            grid, s);
  if (p.hs <= 64) return launch_fp32_kernel(attention_kernel_64<kBias, kSeg, kCausal, false>, p,
                                            grid, s);
  if (p.hs <= kMaxHs) {
    return launch_fp32_kernel(attention_kernel<kMaxHs, kBias, kSeg, kCausal, false>, p, grid, s);
  }
  const long long z = static_cast<long long>(H) * ((p.hs + kSliceD - 1) / kSliceD);
  if (z > 65535) return static_cast<int>(cudaErrorInvalidValue);
  return launch_fp32_kernel(attention_kernel_sliced<kBias, kSeg, kCausal>, p,
                            dim3(B, q_tiles, static_cast<unsigned>(z)), s);
}

}  // namespace set_attention_core

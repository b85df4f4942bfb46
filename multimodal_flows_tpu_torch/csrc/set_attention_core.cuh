// The set-attention core shared by K1 (csrc/btc_attention.cu) and K2
// (csrc/set_attention.cu), for Hopper (sm_90a).
//
// For every row b, head h and query i, in the order of the JAX package's
// `_xla_attention_btc` (multimodal_flows_tpu/ops/attention.py:158-193):
//   s_j   = (q[b,h,i] . k[b,h,j]) * scale
//   s_j  += key_mask[b,j]                        (optional, (B, Tk) fp32)
//   s_j  += bias[b,h,i,j]                        (kBias, fp32, strided)
//   s_j   = -1e9 where segments[b,i] != segments[b,j]   (kSeg, Tq == Tk)
//   out[b,h,i] = sum_j softmax_j(s) v[b,h,j]     (exact softmax, fp32)
// q, k, v, the bias and the output are each a pointer and four element
// strides of a (B, H, T, D) view; a zero bias stride broadcasts.
//
// What bounds set attention on this card.  At the packed-row batch
// (B = 128 rows x T = 128 tokens, H = 4) one call moves 67 MB of q/k/v/out
// at C = 256, plus 33.5 MB of (B, H, T, T) bias in K2: about 30 us at
// 3.35 TB/s (20 us without the bias).  Its 2.15 GFLOP take 13 us at the
// TF32 tensor-core rate with three products per multiply.  The first
// kernels of the port (one key per lane, scalar FMAs) were bound by the
// shared-memory loads that fed the FMAs (5 loads for 4 FMAs) and ran at
// 0.22-0.45 ms, 10-20x above both floors.
//
// What the design does about it.
//   - Tensor cores at fp32 accuracy: `mma.sync.m16n8k8` in TF32 with the
//     3xTF32 split.  Every fp32 operand is split once, when it is staged,
//     into hi = tf32(x) and lo = tf32(x - hi); each product is
//     lo*hi + hi*lo + hi*hi, summed in fp32 (error near 1e-6 at these
//     depths, against about 1e-3 for plain TF32).  This holds for Q K^T
//     and for P V.  The head size is padded to a multiple of 8 with zeros.
//     `wgmma` is left for bf16: its TF32 form wants K-major operands in
//     shared memory (V transposed) and 64-row tiles per warpgroup.
//   - A block is one (row b, head h, tile of 64 queries), 4 warps of 16
//     query rows.  Each warp keeps its q fragments (hi and lo) in
//     registers.  K and V pass in tiles of 32 keys through a double-
//     buffered ring in shared memory, loaded with 16-byte `cp.async` where
//     the strides allow and 4-byte `cp.async` where they do not (odd head
//     sizes, head-major views with Dh % 4 != 0); the next tile's load
//     overlaps the current tile's split and MMAs.  Out-of-range keys and
//     padded dims are zero-filled by the copy.  Shared rows are padded to
//     Dpad + 4 floats, so the fragment loads of K and of V hit 32 banks.
//     Shared memory does not grow with Tk (beyond 8 bytes a key for the
//     key mask and the segment ids).
//   - Softmax online (flash-style), in the accumulator layout: a running
//     max and sum per query row, the output rescaled when the max grows,
//     one division at the end.  Masked scores are -1e9 (finite) as in the
//     plain version, so exp() gives exactly the zeros the two-pass softmax
//     gives, and rows whose every score is -1e9 + bias stay finite.
//   - Cross-jet key tiles are skipped under segments.  Each warp knows the
//     min and max segment id of its queries, each key tile those of its
//     keys, both without the pads' id -1, which is a flag of its own (so
//     the pads at a row's end do not widen the last tile to every jet).  A
//     tile is skipped by a warp when the intervals are disjoint and they do
//     not both hold pads, and not loaded at all when every warp skips it.
//     In a skipped tile every pair is cross-segment, so each probability
//     in it is exactly 0 in fp32 for a query that has an unmasked
//     same-segment key: every query has one, itself (Tq == Tk), and the
//     tile holding it is never skipped.  The test holds for any ids,
//     contiguous or not, pads included.  In K2 the bias of a skipped tile
//     is never read.
//   - The bias is read per accumulator fragment (two adjacent keys per
//     thread, a float2 where the key stride is 1 and the row is 8-byte
//     aligned), issued before the tile's MMAs.  Staging it through shared
//     memory with the K tile was not measured; K2 costs 4-13 us a call
//     more than K1 at the packed-row shapes (PERF.md).
//
// The element type is a template parameter.  fp32 q/k/v take the path
// above.  bf16 q/k/v (the encoders' compute_dtype="bfloat16") take
// `attention_kernel_bf16`: the same blocks, tiles, tile skipping and online
// softmax, with
//   - bf16 Q, K and V tiles staged by 16-byte `cp.async` (8 values a
//     copy) into rows padded to Dpad + 8 values (Dpad = the head size
//     rounded up to 16), so that the fragment loads hit 32 banks;
//   - one `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32` pass per
//     product (no split: the products of two bf16 values are exact in
//     fp32 and summed in fp32, the `preferred_element_type=float32` of the
//     JAX package's bf16 einsums);
//   - the scores, the key mask, the bias (fp32 or bf16, the `BiasT`
//     parameter) and the online softmax in fp32 registers; P rounded to
//     bf16 for the P V product (the plain version rounds the normalised
//     probabilities, this kernel the unnormalised ones before the final
//     division: the same relative rounding), V's fragments read with
//     `ldmatrix.trans` from the row-major tile;
//   - the output written in bf16.
// It moves half the bytes of the fp32 path and does one tensor-core pass
// where the fp32 path does three.  `wgmma` (64-row warpgroup products from
// shared memory) is left for a later change.
// Limits: Tq, Tk <= 256, head size <= 128 (the entry points refuse more).

#pragma once

#include <climits>
#include <cstdint>

#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace set_attention_core {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 16;               // one m16 tile
constexpr int kQTile = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kKTile = 32;                     // keys per staged tile
constexpr int kMaxT = 256;
constexpr int kMaxHs = 128;
constexpr int kMaxTiles = kMaxT / kKTile;
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

// The key tiles the calling warp needs (`need_warp`) and any warp of the
// block needs (`need_block`), as bit masks: every tile, or under segments
// (kSeg) the tiles whose interval of segment ids meets the warp's, or that
// hold pads when the warp's queries do.  Every thread of the block calls
// it; `sg` holds the Tk segment ids in shared memory.
template <bool kSeg>
__device__ __forceinline__ void needed_tiles(const int* sg, int Tq, int Tk, int q0, int warp,
                                             int lane, uint32_t& need_warp,
                                             uint32_t& need_block) {
  // segment intervals (pads excluded) and whether pads are present
  __shared__ int tile_lo[kMaxTiles], tile_hi[kMaxTiles], warp_lo[kWarps], warp_hi[kWarps];
  __shared__ bool tile_pad[kMaxTiles], warp_pad[kWarps];
  const int n_tiles = (Tk + kKTile - 1) / kKTile;
  need_warp = need_block = (1u << n_tiles) - 1u;
  if constexpr (kSeg) {
    for (int t = warp; t < n_tiles; t += kWarps) {
      const int j = t * kKTile + lane;
      const int id = j < Tk ? sg[j] : kPad;
      const int lo = __reduce_min_sync(0xffffffffu, id == kPad ? INT_MAX : id);
      const int hi = __reduce_max_sync(0xffffffffu, id == kPad ? INT_MIN : id);
      const bool pad = __any_sync(0xffffffffu, j < Tk && id == kPad);
      if (lane == 0) tile_lo[t] = lo, tile_hi[t] = hi, tile_pad[t] = pad;
    }
    const int i = q0 + warp * kRowsPerWarp + lane;
    const bool row = lane < kRowsPerWarp && i < Tq;
    const int id = row ? sg[i] : kPad;
    const int lo = __reduce_min_sync(0xffffffffu, id == kPad ? INT_MAX : id);
    const int hi = __reduce_max_sync(0xffffffffu, id == kPad ? INT_MIN : id);
    const bool pad = __any_sync(0xffffffffu, row && id == kPad);
    if (lane == 0) warp_lo[warp] = lo, warp_hi[warp] = hi, warp_pad[warp] = pad;
    need_warp = need_block = 0;
    __syncthreads();
    for (int w = 0; w < kWarps; ++w) {
      for (int t = 0; t < n_tiles; ++t) {
        if ((warp_lo[w] <= tile_hi[t] && tile_lo[t] <= warp_hi[w]) ||
            (warp_pad[w] && tile_pad[t])) {
          need_block |= 1u << t;
          if (w == warp) need_warp |= 1u << t;
        }
      }
    }
  }
}

// The bias of the warp's accumulator fragments for the key tile at key0:
// two adjacent keys a thread, read as one pair where `vec` (key stride 1,
// rows aligned to two values), 0 past Tq or Tk.
template <typename BiasT>
__device__ __forceinline__ void load_bias(float (&bias_v)[4][4], const BiasT* bb,
                                          const Strides& sb, const int (&rows)[2], int Tq,
                                          int Tk, int key0, int c, bool vec) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
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
// scores `s` of the warp's 16 rows against the tile's 32 keys become the
// unnormalised probabilities exp(score - running max), after the scale,
// the key mask, the bias and the segment test; the running max `m`, the
// thread's part of each row's sum `l` and the output accumulators `o` are
// rescaled when the max grows.
template <bool kBias, bool kSeg, int kOut>
__device__ __forceinline__ void softmax_tile(float (&s)[4][4], const float (&bias_v)[4][4],
                                             const float* km, const int* sg,
                                             const int (&seg_row)[2], int key0, int Tk, int c,
                                             float scale, float (&m)[2], float (&l)[2],
                                             float (&o)[kOut][4]) {
  float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < 4; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const int j = key0 + 8 * n + 2 * c + (e & 1);
      float x = -INFINITY;  // keys past Tk take no part
      if (j < Tk) {
        x = s[n][e] * scale + km[j];
        if constexpr (kBias) x += bias_v[n][e];
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
  for (int n = 0; n < 4; ++n) {
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
template <int kMaxD, bool kBias, bool kSeg>
__global__ void __launch_bounds__(kThreads) attention_kernel(const Params p) {
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
  const int q0 = blockIdx.y * kQTile;
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

  // the key tiles this warp, and the block, need
  uint32_t need_warp, need_block;
  needed_tiles<kSeg>(sg, Tq, Tk, q0, warp, lane, need_warp, need_block);

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
  uint32_t todo = need_block;  // never empty: warp 0 has a row
  int t = __ffs(todo) - 1;
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
    const int next = todo ? __ffs(todo) - 1 : -1;
    if (next >= 0) {
      todo &= todo - 1;
      stage(next, buf ^ 1);
    }
    float* kh = kbuf + buf * tile_floats;
    float* vh = vbuf + buf * tile_floats;
    split_tile(kh, klo, stride, dpad);
    split_tile(vh, vlo, stride, dpad);
    __syncthreads();

    if ((need_warp >> t) & 1u) {
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

      softmax_tile<kBias, kSeg>(s, bias_v, km, sg, seg_row, key0, Tk, c, p.scale, m, l, o);

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

// The bf16 path (see the header): one block is (row b, 64 queries, head h)
// as in `attention_kernel`, 4 warps of 16 query rows.  Fragment layouts of
// mma.m16n8k16 (g = lane / 4, c = lane % 4): A holds rows g, g + 8 and
// columns 2c, 2c + 1 (registers 0, 1) and 2c + 8, 2c + 9 (registers 2, 3);
// B holds rows (k) 2c, 2c + 1 and 2c + 8, 2c + 9 of column g; the
// accumulator is that of m16n8k8.  For P V, P's A fragment for 16 keys is
// the score accumulators of its two 8-key column tiles, rounded in pairs.

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices from shared memory, transposed: lane l gives the
// address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

__device__ __forceinline__ uint32_t ld_shared_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Stage rows j0..j0+kRows-1 of one (T, D) bf16 view into a tile of
// `stride` values a row, dims >= hs and rows >= T as zeros: 16-byte
// cp.async (8 values) when `vec`, else value by value (odd head sizes,
// strided views), which the caller's wait and barrier cover alike.
template <int kRows>
__device__ __forceinline__ void stage_rows_bf16(bf16* dst, int stride, const bf16* src,
                                                long long st, long long sd, int j0, int T,
                                                int hs, int dpad, bool vec) {
  if (vec) {
    const int shift = unit_shift<8>(dpad);
    const int d = (threadIdx.x & ((1 << shift) - 1)) * 8;
    if (d >= dpad) return;
    for (int r = threadIdx.x >> shift; r < kRows; r += kThreads >> shift) {
      const int j = j0 + r;
      const bool ok = d < hs && j < T;
      const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst + r * stride + d));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                   "l"(ok ? src + j * st + d : src), "r"(ok ? 16 : 0)
                   : "memory");
    }
    return;
  }
  for (int e = threadIdx.x; e < kRows * dpad; e += kThreads) {
    const int r = e / dpad, d = e - r * dpad, j = j0 + r;
    dst[r * stride + d] = d < hs && j < T ? src[j * st + d * sd] : __float2bfloat16(0.f);
  }
}

template <int kMaxD, bool kBias, bool kSeg, typename BiasT>
__global__ void __launch_bounds__(kThreads) attention_kernel_bf16(const ParamsT<bf16, BiasT> p) {
  constexpr int kSteps = kMaxD / 16;  // 16-deep steps of Q K^T over the head dims
  constexpr int kOut = kMaxD / 8;     // 8-wide output tiles of P V
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int hs = p.hs, Tq = p.Tq, Tk = p.Tk;
  const int dpad = (hs + 15) & ~15;
  const int nk = dpad / 16, nout = dpad / 8;
  const int stride = dpad + 8;  // values a row: == 4 mod 8 words, conflict-free
  const int tile_vals = kKTile * stride;
  bf16* kbuf = reinterpret_cast<bf16*>(smem_raw);  // 2 tiles of K
  bf16* vbuf = kbuf + 2 * tile_vals;               // 2 tiles of V
  bf16* qs = kbuf;  // before the first tile: the 64 query rows (2 tiles' room)
  float* km = reinterpret_cast<float*>(vbuf + 2 * tile_vals);  // Tk key mask
  int* sg = reinterpret_cast<int*>(km + Tk);                     // Tk segment ids

  const int b = blockIdx.x;
  const int h = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int c = lane & 3;

  const bf16* qb = p.q + b * p.sq.b + h * p.sq.h;
  const bf16* kb = p.k + b * p.sk.b + h * p.sk.h;
  const bf16* vb = p.v + b * p.sv.b + h * p.sv.h;
  const BiasT* bb = kBias ? p.bias + b * p.sb.b + h * p.sb.h : nullptr;
  bf16* ob = p.out + b * p.so.b + h * p.so.h;

  const int q0 = blockIdx.y * kQTile;
  stage_rows_bf16<kQTile>(qs, stride, qb, p.sq.t, p.sq.d, q0, Tq, hs, dpad,
                          p.sq.d == 1 && p.sq.t % 8 == 0 && hs % 8 == 0 && aligned(qb, 16));
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

  // the warp's q fragments
  uint32_t qf[kSteps][4];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = warp * kRowsPerWarp + g + ((e & 1) ? 8 : 0);
      const int d = 16 * ks + 2 * c + ((e & 2) ? 8 : 0);
      qf[ks][e] = ks < nk ? ld_shared_u32(qs + r * stride + d) : 0u;
    }
  }

  uint32_t need_warp, need_block;
  needed_tiles<kSeg>(sg, Tq, Tk, q0, warp, lane, need_warp, need_block);

  const bool k_vec = p.sk.d == 1 && p.sk.t % 8 == 0 && hs % 8 == 0 && aligned(kb, 16);
  const bool v_vec = p.sv.d == 1 && p.sv.t % 8 == 0 && hs % 8 == 0 && aligned(vb, 16);
  auto stage = [&](int t, int buf) {
    stage_rows_bf16<kKTile>(kbuf + buf * tile_vals, stride, kb, p.sk.t, p.sk.d, t * kKTile, Tk,
                            hs, dpad, k_vec);
    stage_rows_bf16<kKTile>(vbuf + buf * tile_vals, stride, vb, p.sv.t, p.sv.d, t * kKTile, Tk,
                            hs, dpad, v_vec);
    cp_async_commit();
  };

  __syncthreads();  // every warp holds its q fragments: qs may be overwritten
  uint32_t todo = need_block;  // never empty: warp 0 has a row
  int t = __ffs(todo) - 1;
  todo &= todo - 1;
  stage(t, 0);

  const int row0 = q0 + warp * kRowsPerWarp + g;
  const int rows[2] = {row0, row0 + 8};
  int seg_row[2] = {0, 0};
  if constexpr (kSeg) {
#pragma unroll
    for (int r = 0; r < 2; ++r) seg_row[r] = rows[r] < Tq ? sg[rows[r]] : -1;
  }
  const bool bias_vec = kBias && p.sb.d == 1 && p.sb.t % 2 == 0 && aligned(bb, 2 * sizeof(BiasT));

  float o[kOut][4];
#pragma unroll
  for (int n = 0; n < kOut; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int buf = 0;; buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // tile t landed; every warp is done with the previous tile
    const int next = todo ? __ffs(todo) - 1 : -1;
    if (next >= 0) {
      todo &= todo - 1;
      stage(next, buf ^ 1);
    }
    const bf16* kt = kbuf + buf * tile_vals;
    const bf16* vt = vbuf + buf * tile_vals;

    if ((need_warp >> t) & 1u) {
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
            const bf16* kr = kt + (8 * n + g) * stride + 16 * ks + 2 * c;
            mma_bf16(s[n], qf[ks], ld_shared_u32(kr), ld_shared_u32(kr + 8));
          }
        }
      }

      softmax_tile<kBias, kSeg>(s, bias_v, km, sg, seg_row, key0, Tk, c, p.scale, m, l, o);

      // P V: 16 keys at a time, P from the score accumulators of two 8-key
      // tiles, V's fragments of two 8-dim tiles per ldmatrix
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {
        const uint32_t a[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                               pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                               pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                               pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
        const bf16* vrow = vt + (16 * kc + (lane & 15)) * stride + 8 * (lane >> 4);
#pragma unroll
        for (int n = 0; n < kOut; n += 2) {
          if (n < nout) {
            uint32_t bv[4];
            ldmatrix_x4_trans(bv, vrow + 8 * n);
            mma_bf16(o[n], a, bv[0], bv[1]);
            mma_bf16(o[n + 1], a, bv[2], bv[3]);
          }
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
  for (int n = 0; n < kOut; ++n) {
    if (n < nout) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = rows[e >> 1];
        const int d = 8 * n + 2 * c + (e & 1);
        if (i < Tq && d < hs) {
          ob[i * p.so.t + d * p.so.d] = __float2bfloat16(o[n][e] * inv[e >> 1]);
        }
      }
    }
  }
}

template <int kMaxD, bool kBias, bool kSeg, typename T, typename BiasT>
int launch_padded(const ParamsT<T, BiasT>& p, int B, int H, cudaStream_t stream) {
  size_t smem;
  void (*kernel)(const ParamsT<T, BiasT>);
  if constexpr (std::is_same_v<T, float>) {
    static_assert(std::is_same_v<BiasT, float>, "fp32 q/k/v take an fp32 bias");
    const int stride = ((p.hs + 7) & ~7) + 4;
    smem = sizeof(float) * (6 * static_cast<size_t>(kKTile) * stride + p.Tk) +
           sizeof(int) * p.Tk;
    kernel = attention_kernel<kMaxD, kBias, kSeg>;
  } else {
    const int stride = ((p.hs + 15) & ~15) + 8;
    smem = sizeof(bf16) * 4 * static_cast<size_t>(kKTile) * stride +
           (sizeof(float) + sizeof(int)) * p.Tk;
    kernel = attention_kernel_bf16<kMaxD, kBias, kSeg, BiasT>;
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(B, (p.Tq + kQTile - 1) / kQTile, H);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Launches the core on `stream` for B rows and H heads, in the element type
// of `p` (float or bf16); returns the launch's cudaError_t.  The caller has
// checked the limits.
template <bool kBias, bool kSeg, typename T, typename BiasT>
int launch(const ParamsT<T, BiasT>& p, int B, int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.hs <= 32) return launch_padded<32, kBias, kSeg>(p, B, H, s);
  if (p.hs <= 64) return launch_padded<64, kBias, kSeg>(p, B, H, s);
  return launch_padded<kMaxHs, kBias, kSeg>(p, B, H, s);
}

}  // namespace set_attention_core

// K1: segment-masked, token-major set attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_btc_kernel`
// (multimodal_flows_tpu/ops/pallas_attention.py:201-257, launched by
// `_btc_forward` at :309).  Same math: for every row b and head h,
//   out[b, i, h] = softmax_j(q[b,i,h] . k[b,j,h] / sqrt(hs) + key_mask[b,j]) v[b,j,h]
// with the score replaced by -1e9 where segments[b,i] != segments[b,j],
// an exact max-subtracted softmax in fp32, q/k/v/out (B, T, C) fp32
// contiguous with the H heads packed in C = H * hs.
//
// What bounds it on the card: at the flagship packed rows (B = 128,
// T = 128, H = 4, C = 256) one call moves 4 * B*T*C*4 = 67 MB, 20 us at
// 3.35 TB/s, and does 4 * B*T*T*C = 2.15 GFLOP, 13 us at the TF32
// tensor-core rate with three products per multiply; a packed row of 128
// holds about 3 jets, so only about a third of the pairs are same-jet.
//
// What the design does about it: it is the shared core of
// csrc/set_attention_core.cuh (3xTF32 `wgmma` at fp32 accuracy, the raw
// fp32 tiles by TMA serving as the hi parts, K's lo part and V^T made by
// one thread pass a tile, a ring of key-tile chunks on mbarriers, online
// softmax in registers, cross-jet key tiles not loaded under segments,
// the keys split across blocks on grids that fill at most half the card),
// instantiated with K1's contiguous (B, T, C) strides and no bias.  The
// TPU kernel replicated each row H times with lane masks to fill a
// 128-lane MXU (an H*T x H*T score matrix with a block penalty); on Hopper
// that is H times the work, so it is not carried over.
// bf16 (`btc_attention_bf16_fwd`): q/k/v/out (B, T, C) bf16, the core's
// bf16 path (a block's TMA loads in flight together, `wgmma` products,
// fp32 scores and softmax, P rounded to bf16): half the bytes, 33.5 MB at
// C = 256, 10 us.
// Shapes: any T and head size whose shared memory fits a block (the
// core's header says what bounds them); head sizes past 128 run in slices
// of 128 output columns.

#include "set_attention_core.cuh"

namespace core = set_attention_core;

// Launches K1 on `stream`; key_mask and segments may be null.  The host's
// plan (ops/set_attention.py:fp32_plan): `qkv_tma` (q, k and v by TMA),
// `stages` (of the ring of key-tile chunks), `splits` (of the key tiles
// across blocks; `part` the scratch of the split rows, null without) and
// `smem` (the launch's shared memory, as core::fp32_smem counts it).
// Returns the launch's cudaError_t (0 on success); the kernel itself is not
// awaited.
extern "C" int btc_attention_fwd(const float* q, const float* k, const float* v,
                                 const float* key_mask, const int* segments,
                                 float* out, int B, int T, int C, int n_head,
                                 float scale, int qkv_tma, int stages, int splits, int smem,
                                 float* part, void* stream) {
  if (B <= 0 || T <= 0 || n_head <= 0 || C % n_head != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int hs = C / n_head;
  const core::Strides s{static_cast<long long>(T) * C, hs, C, 1};
  const core::Params p{q,        s,       k,        s,   v,  s, key_mask, nullptr,
                       core::Strides{0, 0, 0, 0}, segments, out, s, T, T, hs, scale};
  return segments != nullptr
             ? core::launch_fp32<false, true>(p, B, n_head, qkv_tma, stages, splits, smem, part,
                                              stream)
             : core::launch_fp32<false, false>(p, B, n_head, qkv_tma, stages, splits, smem, part,
                                               stream);
}

// The bf16 form: q, k, v and out are __nv_bfloat16 (B, T, C), the key mask
// fp32; otherwise as btc_attention_fwd.  The host's plan: `qkv_tma` (q, k
// and v by TMA), `stages` (of the ring of key tiles or chunks) and `smem`
// (the launch's shared memory, as core::bf16_smem counts it).
extern "C" int btc_attention_bf16_fwd(const void* q, const void* k, const void* v,
                                      const float* key_mask, const int* segments, void* out,
                                      int B, int T, int C, int n_head, float scale, int qkv_tma,
                                      int stages, int smem, void* stream) {
  if (B <= 0 || T <= 0 || n_head <= 0 || C % n_head != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int hs = C / n_head;
  using core::bf16;
  const core::Strides s{static_cast<long long>(T) * C, hs, C, 1};
  const core::ParamsT<bf16> p{static_cast<const bf16*>(q), s, static_cast<const bf16*>(k), s,
                              static_cast<const bf16*>(v), s, key_mask, nullptr,
                              core::Strides{0, 0, 0, 0}, segments, static_cast<bf16*>(out), s,
                              T, T, hs, scale};
  return segments != nullptr
             ? core::launch_bf16<false, true>(p, B, n_head, qkv_tma, 0, stages, smem, stream)
             : core::launch_bf16<false, false>(p, B, n_head, qkv_tma, 0, stages, smem, stream);
}

extern "C" const char* btc_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

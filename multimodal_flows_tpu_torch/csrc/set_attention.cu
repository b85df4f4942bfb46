// K2: biased set attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel`
// (multimodal_flows_tpu/ops/pallas_attention.py:48-71, launched by
// `_pallas_forward` at :113).  Same math, in the order of
// `_xla_attention_btc` (ops/attention.py:165-173) and `_xla_reference`:
// for every row b, head h and query i,
//   s_j   = (q[b,h,i] . k[b,h,j]) * scale
//   s_j  += key_mask[b,j]                       (optional, (B, Tk) fp32)
//   s_j  += bias[b,h,i,j]                       (optional, fp32, strided)
//   s_j   = -1e9 where segments[b,i] != segments[b,j]   (with a bias, Tq == Tk)
//   out[b,h,i] = sum_j softmax_j(s) v[b,h,j]    (exact softmax, fp32)
// q is (B, H, Tq, Dh), k and v (B, H, Tk, Dh), each given as a pointer
// and four element strides, so the head-major tensors of CrossAttention
// and the token-major view (B, T, H, hs) of a (B, T, C) tensor both go in
// without a copy; the output is written through its own four strides.
// A zero bias stride broadcasts over B or H: the (B, 1, T, T) pair mask
// is never expanded.
//
// What bounds it on the card.  At the packed rows (B = 128, T = 128,
// H = 4, C = 256) one call moves 67 MB of q/k/v/out and reads a
// (B, H, T, T) fp32 bias of 33.5 MB: about 30 us at 3.35 TB/s.  Its
// 2.15 GFLOP take 13 us at the TF32 tensor-core rate with three products
// per multiply.  Two thirds of the pairs of a packed row are cross-jet,
// so most of the bias is read for scores that are then replaced by -1e9.
//
// What the design does about it: it is the shared core of
// csrc/set_attention_core.cuh (3xTF32 `wgmma`, the raw fp32 tiles by TMA
// as the hi parts, a ring of key-tile chunks on mbarriers, online
// softmax), instantiated with the 20 strides as given.  The bias is read
// per accumulator fragment, a float2 where the key stride is 1, and only
// for key tiles that some query of the block can attend to: under
// segments the cross-jet tiles, and their bias, are skipped.  The Pallas
// block of 8 jets x all heads per grid step is a TPU device (its grid runs
// in order) and is not carried over.
// bf16 (`set_attention_bf16_fwd`): q, k, v and out bf16 with the same
// strides, the bias fp32 or bf16 (a bf16 bias halves its 33.5 MB), the
// core's bf16 path (a block's TMA loads in flight together, `wgmma` products,
// fp32 scores and softmax, P rounded to bf16), the bias through shared
// memory where TMA can read it.
// Causal (`set_attention_causal_fwd`, GPT's full forward): the fp32 path
// with the causal term computed in the kernel instead of a (1, 1, T, T)
// bias read from memory, and the key tiles past each block's last query
// not loaded: the same scores the bias form computes, about half its
// tiles.
// Shapes: any Tq, Tk and Dh whose shared memory fits a block (the core's
// header says what bounds them); head sizes past 128 run in slices of 128
// output columns.

#include "set_attention_core.cuh"

namespace core = set_attention_core;

namespace {

core::Strides strides_at(const long long* s) { return core::Strides{s[0], s[1], s[2], s[3]}; }

}  // namespace

// Launches K2 on `stream`.  `strides` holds 20 element strides, four
// (B, H, T, D) strides each for q, k, v, bias and out (the bias's four
// are read only when bias is non-null; a zero stride broadcasts).
// key_mask (B, Tk) and bias may be null; segments (B, Tq), Tq == Tk, may
// be null and are taken only with a bias (without one it is K1's form).
// The host's plan (ops/set_attention.py:fp32_plan): `qkv_tma`, `stages`,
// `splits` (with `part`, the scratch of the split rows) and `smem`, as
// btc_attention_fwd takes them.  Returns the launch's cudaError_t (0 on
// success); the kernel itself is not awaited.
extern "C" int set_attention_fwd(const float* q, const float* k, const float* v,
                                 const float* key_mask, const float* bias,
                                 const int* segments, float* out,
                                 const long long* strides, int B, int H, int Tq,
                                 int Tk, int hs, float scale, int qkv_tma, int stages,
                                 int splits, int smem, float* part, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || hs <= 0 ||
      (segments != nullptr && (Tq != Tk || bias == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const core::Params p{q,          strides_at(strides),      k,
                       strides_at(strides + 4),               v,
                       strides_at(strides + 8),               key_mask,
                       bias,       strides_at(strides + 12), segments,
                       out,        strides_at(strides + 16), Tq,
                       Tk,         hs,                        scale};
  if (bias == nullptr) {
    return core::launch_fp32<false, false>(p, B, H, qkv_tma, stages, splits, smem, part, stream);
  }
  return segments != nullptr
             ? core::launch_fp32<true, true>(p, B, H, qkv_tma, stages, splits, smem, part, stream)
             : core::launch_fp32<true, false>(p, B, H, qkv_tma, stages, splits, smem, part,
                                              stream);
}

// The causal form: q, k, v and out (B, H, T, Dh) fp32 given by 16 element
// strides (q, k, v, out), key_mask (B, T) or null; Tq == Tk == T, no bias,
// no segments; the plan as set_attention_fwd takes it.  Returns the
// launch's cudaError_t.
extern "C" int set_attention_causal_fwd(const float* q, const float* k, const float* v,
                                        const float* key_mask, float* out,
                                        const long long* strides, int B, int H, int T, int hs,
                                        float scale, int qkv_tma, int stages, int splits,
                                        int smem, float* part, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || hs <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const core::Params p{q,       strides_at(strides),      k,        strides_at(strides + 4),
                       v,       strides_at(strides + 8),  key_mask, nullptr,
                       core::Strides{0, 0, 0, 0},         nullptr,  out,
                       strides_at(strides + 12),          T,        T,
                       hs,      scale};
  return core::launch_fp32<false, false, true>(p, B, H, qkv_tma, stages, splits, smem, part,
                                               stream);
}

namespace {

template <typename BiasT>
int launch_bf16(const void* q, const void* k, const void* v, const float* key_mask,
                const BiasT* bias, const int* segments, void* out, const long long* strides,
                int B, int H, int Tq, int Tk, int hs, float scale, int qkv_tma, int bias_tma,
                int stages, int smem, void* stream) {
  using core::bf16;
  const core::ParamsT<bf16, BiasT> p{static_cast<const bf16*>(q), strides_at(strides),
                                     static_cast<const bf16*>(k), strides_at(strides + 4),
                                     static_cast<const bf16*>(v), strides_at(strides + 8),
                                     key_mask,                     bias,
                                     strides_at(strides + 12),     segments,
                                     static_cast<bf16*>(out),      strides_at(strides + 16),
                                     Tq,                           Tk,
                                     hs,                           scale};
  if constexpr (std::is_same_v<BiasT, float>) {  // the bias-free form, once
    if (bias == nullptr) {
      return core::launch_bf16<false, false>(p, B, H, qkv_tma, 0, stages, smem, stream);
    }
  }
  return segments != nullptr
             ? core::launch_bf16<true, true>(p, B, H, qkv_tma, bias_tma, stages, smem, stream)
             : core::launch_bf16<true, false>(p, B, H, qkv_tma, bias_tma, stages, smem, stream);
}

}  // namespace

// The bf16 form: q, k, v and out are __nv_bfloat16, the bias __nv_bfloat16
// when `bias_bf16` is nonzero and fp32 otherwise, the key mask fp32;
// otherwise as set_attention_fwd.  The host's plan: `qkv_tma` (q, k and v
// by TMA), `bias_tma` (the bias by TMA), `stages` (of the ring of key tiles
// or chunks) and `smem` (the launch's shared memory, as core::bf16_smem
// counts it).
extern "C" int set_attention_bf16_fwd(const void* q, const void* k, const void* v,
                                      const float* key_mask, const void* bias, int bias_bf16,
                                      const int* segments, void* out,
                                      const long long* strides, int B, int H, int Tq, int Tk,
                                      int hs, float scale, int qkv_tma, int bias_tma, int stages,
                                      int smem, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || hs <= 0 ||
      (segments != nullptr && (Tq != Tk || bias == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bias != nullptr && bias_bf16) {
    return launch_bf16(q, k, v, key_mask, static_cast<const core::bf16*>(bias), segments, out,
                       strides, B, H, Tq, Tk, hs, scale, qkv_tma, bias_tma, stages, smem,
                       stream);
  }
  return launch_bf16(q, k, v, key_mask, static_cast<const float*>(bias), segments, out,
                     strides, B, H, Tq, Tk, hs, scale, qkv_tma, bias_tma, stages, smem,
                       stream);
}

extern "C" const char* set_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

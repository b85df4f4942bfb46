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
//   s_j   = -1e9 where segments[b,i] != segments[b,j]   (optional, Tq == Tk)
//   out[b,h,i] = sum_j softmax_j(s) v[b,h,j]    (exact two-pass, fp32)
// q is (B, H, Tq, Dh), k and v (B, H, Tk, Dh), each given as a pointer
// and four element strides, so the head-major tensors of CrossAttention
// and the token-major view (B, T, H, hs) of a (B, T, C) tensor both go in
// without a copy; the output is written through its own four strides.
// A zero bias stride broadcasts over B or H: the (B, 1, T, T) pair mask
// is never expanded.
//
// What bounds it on the card.  At the co-occurrence packed batch (88
// rows x 128 tokens, H = 4) one call reads q/k/v of 17.3 MB at C = 128
// (34.6 MB at C = 256) and a (B, H, T, T) fp32 bias of 23.1 MB, and does
// 4 * B*T*T*C = 0.74 GFLOP at C = 128.  At the card's 3.35 TB/s the bias
// alone costs about 7 us and everything about 14 us; the FMAs take 11 us
// at the fp32 CUDA-core peak.  As in K1, what actually bounds it is the
// shared-memory traffic that feeds the FMAs (K1, the same loop without
// the bias, runs 0.14-0.27 ms at these shapes; PERF.md), so the bias is
// a small extra read, not the bound.
//
// What the design does about it.  It is K1's (csrc/btc_attention.cu):
//   - grid (B, ceil(Tq/32), H): one block per row, tile of 32 query rows
//     and head, 8 warps, each warp owns 4 query rows;
//   - K, then V, are staged through shared memory in chunks of <= 128
//     keys, K rows padded to Dh+1 floats so the 32 lanes of a warp (one
//     key each) hit 32 different banks;
//   - the bias is added as the scores are written: lane j reads
//     bias[b,h,i,c0+j], so each element is read once per call, coalesced
//     along the keys (stride 1 along Tk in every caller);
//   - the scores of the block's 32 rows stay in shared memory, so the
//     softmax is the exact two-pass max-subtracted form, and pad query
//     rows (all -1e9 + bias) stay finite;
//   - in PV each lane owns the output dims lane + 32*dd (Dh <= 128).
// The Pallas block of 8 jets x all heads per grid step is a TPU device
// (its grid runs in order) and is not carried over.
// Limits: Tq, Tk <= 256, Dh <= 128 (the wrapper raises beyond them).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 4;
constexpr int kQTile = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kMaxT = 256;
constexpr int kMaxHs = 128;
constexpr int kDimsPerLane = kMaxHs / 32;
constexpr int kMaxChunk = 128;                 // keys staged at once
constexpr float kNeg = -1e9f;

// element strides of a (B, H, T, D) view
struct Strides {
  long long b, h, t, d;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(kThreads)
set_attention_kernel(const float* __restrict__ q, Strides sq,
                     const float* __restrict__ k, Strides sk,
                     const float* __restrict__ v, Strides sv,
                     const float* __restrict__ key_mask,
                     const float* __restrict__ bias, Strides sb,
                     const int* __restrict__ segments,
                     float* __restrict__ out, Strides so,
                     int Tq, int Tk, int hs, int chunk, float scale) {
  extern __shared__ float smem[];
  const int kv_stride = hs + 1;
  float* qs = smem;                             // kQTile * hs   query rows
  float* ss = qs + kQTile * hs;                 // kQTile * Tk   scores, then exp
  float* buf = ss + kQTile * Tk;                // chunk * kv_stride  K, then V
  float* ms = buf + chunk * kv_stride;          // Tk            key mask
  int* sg = reinterpret_cast<int*>(ms + Tk);    // Tk            segment ids

  const int b = blockIdx.x;
  const int row_base = blockIdx.y * kQTile;
  const int h = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const float* bb = bias ? bias + b * sb.b + h * sb.h : nullptr;
  float* ob = out + b * so.b + h * so.h;

  for (int idx = tid; idx < kQTile * hs; idx += kThreads) {
    const int r = idx / hs;
    const int d = idx - r * hs;
    const int i = row_base + r;
    qs[idx] = i < Tq ? qb[i * sq.t + d * sq.d] : 0.f;
  }
  for (int j = tid; j < Tk; j += kThreads) {
    ms[j] = key_mask ? key_mask[static_cast<long long>(b) * Tk + j] : 0.f;
    sg[j] = segments ? segments[static_cast<long long>(b) * Tk + j] : 0;
  }

  const int r0 = warp * kRowsPerWarp;           // the warp's first row in the tile
  const float* qw = qs + r0 * hs;
  float* sw = ss + r0 * Tk;

  // phase 1: scores, one chunk of keys at a time
  for (int c0 = 0; c0 < Tk; c0 += chunk) {
    const int n = min(chunk, Tk - c0);
    __syncthreads();  // staging done / previous chunk consumed
    for (int idx = tid; idx < n * hs; idx += kThreads) {
      const int j = idx / hs;
      const int d = idx - j * hs;
      buf[j * kv_stride + d] = kb[(c0 + j) * sk.t + d * sk.d];
    }
    __syncthreads();
    for (int j = lane; j < n; j += 32) {
      const float* kr = buf + j * kv_stride;
      float s[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
      for (int d = 0; d < hs; ++d) {
        const float kd = kr[d];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) s[r] = fmaf(qw[r * hs + d], kd, s[r]);
      }
      const int jj = c0 + j;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int i = row_base + r0 + r;
        float x = s[r] * scale;
        x += ms[jj];
        if (i < Tq) {
          if (bb != nullptr) x += bb[i * sb.t + jj * sb.d];
          if (segments != nullptr && sg[jj] != sg[i]) x = kNeg;
        }
        sw[r * Tk + jj] = x;
      }
    }
  }
  __syncwarp();

  // phase 2: exact max-subtracted softmax of each of the warp's rows
  float inv[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    float* p = sw + r * Tk;
    float mx = -INFINITY;
    for (int j = lane; j < Tk; j += 32) mx = fmaxf(mx, p[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < Tk; j += 32) {
      const float e = expf(p[j] - mx);
      p[j] = e;
      sum += e;
    }
    inv[r] = 1.f / warp_sum(sum);
  }

  // phase 3: P V, one chunk of values at a time
  float acc[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int dd = 0; dd < kDimsPerLane; ++dd) acc[r][dd] = 0.f;

  for (int c0 = 0; c0 < Tk; c0 += chunk) {
    const int n = min(chunk, Tk - c0);
    __syncthreads();  // scores written / previous chunk consumed
    for (int idx = tid; idx < n * hs; idx += kThreads) {
      const int j = idx / hs;
      const int d = idx - j * hs;
      buf[j * kv_stride + d] = vb[(c0 + j) * sv.t + d * sv.d];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float* vr = buf + j * kv_stride;
      float p[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) p[r] = sw[r * Tk + c0 + j];
#pragma unroll
      for (int dd = 0; dd < kDimsPerLane; ++dd) {
        const int d = lane + 32 * dd;
        if (d < hs) {
          const float vd = vr[d];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) acc[r][dd] = fmaf(p[r], vd, acc[r][dd]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = row_base + r0 + r;
    if (i < Tq) {
#pragma unroll
      for (int dd = 0; dd < kDimsPerLane; ++dd) {
        const int d = lane + 32 * dd;
        if (d < hs) ob[i * so.t + d * so.d] = acc[r][dd] * inv[r];
      }
    }
  }
}

Strides strides_at(const long long* s) { return Strides{s[0], s[1], s[2], s[3]}; }

}  // namespace

// Launches K2 on `stream`.  `strides` holds 20 element strides, four
// (B, H, T, D) strides each for q, k, v, bias and out (the bias's four
// are read only when bias is non-null; a zero stride broadcasts).
// key_mask (B, Tk), bias and segments (B, Tq), Tq == Tk, may be null.
// Returns the launch's cudaError_t (0 on success); the kernel itself is
// not awaited.
extern "C" int set_attention_fwd(const float* q, const float* k, const float* v,
                                 const float* key_mask, const float* bias,
                                 const int* segments, float* out,
                                 const long long* strides, int B, int H, int Tq,
                                 int Tk, int hs, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || Tq > kMaxT || Tk > kMaxT || hs <= 0 ||
      hs > kMaxHs || (segments != nullptr && Tq != Tk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int chunk = Tk < kMaxChunk ? Tk : kMaxChunk;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kQTile) * hs + static_cast<size_t>(kQTile) * Tk +
                       static_cast<size_t>(chunk) * (hs + 1) + Tk) +
      sizeof(int) * Tk;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        set_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(B, (Tq + kQTile - 1) / kQTile, H);
  set_attention_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, strides_at(strides), k, strides_at(strides + 4), v, strides_at(strides + 8),
      key_mask, bias, strides_at(strides + 12), segments, out, strides_at(strides + 16),
      Tq, Tk, hs, chunk, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* set_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

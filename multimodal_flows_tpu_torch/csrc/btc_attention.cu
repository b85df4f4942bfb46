// K1: segment-masked, token-major set attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_btc_kernel`
// (multimodal_flows_tpu/ops/pallas_attention.py:201-257, launched by
// `_btc_forward` at :309).  Same math: for every row b and head h,
//   out[b, i, h] = softmax_j(q[b,i,h] . k[b,j,h] / sqrt(hs) + key_mask[b,j]) v[b,j,h]
// with the score replaced by -1e9 where segments[b,i] != segments[b,j],
// an exact max-subtracted softmax in fp32, q/k/v/out (B, T, C) fp32 with
// the H heads packed in C = H * hs.
//
// What bounds it on the card: at the flagship shapes (T = 128, hs = 32 or
// 64) one call moves 4 * B*T*C*4 bytes (33.5 MB at C = 128, B = 128) and
// does 4 * B*T*T*C flops (1.07 GFLOP), about 32 flop/byte: above the fp32
// CUDA-core ridge (67 TFLOP/s over 3.35 TB/s, about 20), so the FMA units
// and the shared-memory loads that feed them bound it, not HBM.
//
// What the design does about it.  The TPU kernel replicated each row H
// times with lane masks to fill a 128-lane MXU (an H*T x H*T score
// matrix with a block penalty); on Hopper that is H times the work, so
// it is not carried over.  Instead:
//   - grid (B, ceil(T/32), H): one block per row, tile of 32 query rows
//     and head, 8 warps, each warp owns 4 query rows;
//   - K, then V, are staged through shared memory in chunks of <= 128
//     keys, with K rows padded to hs+1 floats so the 32 lanes of a warp
//     (one key each) hit 32 different banks;
//   - each K or V element loaded from shared memory feeds the warp's 4
//     query rows (4 FMAs per load);
//   - the scores of the block's 32 rows stay in shared memory, so the
//     softmax is the exact two-pass max-subtracted form (warp shuffles for
//     max and sum), and rows that are all pad stay finite;
//   - in PV each lane owns the output dims lane + 32*dd (hs <= 128).
// Limits: T <= 256, hs <= 128 (the wrapper raises beyond them).  Tensor
// cores (mma/wgmma on TF32 or bf16) are left for a later change.

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
btc_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ key_mask,
                     const int* __restrict__ segments, float* __restrict__ out,
                     int T, int C, int hs, int chunk, float scale) {
  extern __shared__ float smem[];
  const int kv_stride = hs + 1;
  float* qs = smem;                             // kQTile * hs   query rows
  float* ss = qs + kQTile * hs;                 // kQTile * T    scores, then exp
  float* buf = ss + kQTile * T;                 // chunk * kv_stride  K, then V
  float* ms = buf + chunk * kv_stride;          // T             key mask
  int* sg = reinterpret_cast<int*>(ms + T);     // T             segment ids

  const int b = blockIdx.x;
  const int row_base = blockIdx.y * kQTile;
  const int h = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long tok0 = static_cast<long long>(b) * T;
  const int col0 = h * hs;

  for (int idx = tid; idx < kQTile * hs; idx += kThreads) {
    const int r = idx / hs;
    const int d = idx - r * hs;
    const int i = row_base + r;
    qs[idx] = i < T ? q[(tok0 + i) * C + col0 + d] : 0.f;
  }
  for (int j = tid; j < T; j += kThreads) {
    ms[j] = key_mask ? key_mask[tok0 + j] : 0.f;
    sg[j] = segments ? segments[tok0 + j] : 0;
  }

  const int r0 = warp * kRowsPerWarp;           // the warp's first row in the tile
  const float* qw = qs + r0 * hs;
  float* sw = ss + r0 * T;

  // phase 1: scores, one chunk of keys at a time
  for (int c0 = 0; c0 < T; c0 += chunk) {
    const int n = min(chunk, T - c0);
    __syncthreads();  // staging done / previous chunk consumed
    for (int idx = tid; idx < n * hs; idx += kThreads) {
      const int j = idx / hs;
      const int d = idx - j * hs;
      buf[j * kv_stride + d] = k[(tok0 + c0 + j) * C + col0 + d];
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
        float x = s[r] * scale + ms[jj];
        const int i = row_base + r0 + r;
        if (segments != nullptr && i < T && sg[jj] != sg[i]) x = kNeg;
        sw[r * T + jj] = x;
      }
    }
  }
  __syncwarp();

  // phase 2: exact max-subtracted softmax of each of the warp's rows
  float inv[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    float* p = sw + r * T;
    float mx = -INFINITY;
    for (int j = lane; j < T; j += 32) mx = fmaxf(mx, p[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < T; j += 32) {
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

  for (int c0 = 0; c0 < T; c0 += chunk) {
    const int n = min(chunk, T - c0);
    __syncthreads();  // scores written / previous chunk consumed
    for (int idx = tid; idx < n * hs; idx += kThreads) {
      const int j = idx / hs;
      const int d = idx - j * hs;
      buf[j * kv_stride + d] = v[(tok0 + c0 + j) * C + col0 + d];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float* vr = buf + j * kv_stride;
      float p[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) p[r] = sw[r * T + c0 + j];
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
    if (i < T) {
#pragma unroll
      for (int dd = 0; dd < kDimsPerLane; ++dd) {
        const int d = lane + 32 * dd;
        if (d < hs) out[(tok0 + i) * C + col0 + d] = acc[r][dd] * inv[r];
      }
    }
  }
}

}  // namespace

// Launches K1 on `stream`; key_mask and segments may be null.  Returns the
// launch's cudaError_t (0 on success); the kernel itself is not awaited.
extern "C" int btc_attention_fwd(const float* q, const float* k, const float* v,
                                 const float* key_mask, const int* segments,
                                 float* out, int B, int T, int C, int n_head,
                                 float scale, void* stream) {
  if (B <= 0 || T <= 0 || T > kMaxT || n_head <= 0 || C % n_head != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int hs = C / n_head;
  if (hs > kMaxHs) return static_cast<int>(cudaErrorInvalidValue);
  const int chunk = T < kMaxChunk ? T : kMaxChunk;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kQTile) * hs + static_cast<size_t>(kQTile) * T +
                       static_cast<size_t>(chunk) * (hs + 1) + T) +
      sizeof(int) * T;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        btc_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(B, (T + kQTile - 1) / kQTile, n_head);
  btc_attention_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, key_mask, segments, out, T, C, hs, chunk, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* btc_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

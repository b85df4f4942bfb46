// The Lund pair MLP of KinFormer's pair bias, fused, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package runs this MLP as plain XLA
// (`KinFormer._lund_bias`), and so did the port, as ten-odd PyTorch passes
// a chunk of query rows (ops/lund_pair_mlp.py:lund_pair_mlp_reference).
// It was added because those passes were most of the device time of CFM
// sampling over KinFormer with `use_pairwise`: each wrote a 256-wide fp32
// hidden of every (row, i, j) slot pair to device memory and read it back.
//
// For every pair p = (b, i, j) of U (B, D, D, 2), in the reference's order:
//   a   = LN(gelu(W1 U[b,i,j] + b1)),  at = LN(gelu(W1 U[b,j,i] + b1))
//         (Dense 2 -> C, exact erf GELU, LayerNorm over C: eps 1e-6 in KinFormer)
//   x   = 0.5 (a + at)
//   z   = gelu(W_fc x + b_fc)                       (C -> C)
//   out[b,h,i,j] = lambda_u (W_out z + b_out)[h]    (C -> H)
// C = 256 (n_embd at the training CLI's widths, scripts/train_mmf.py) and
// H <= 4; the biases of W_fc and W_out may be absent;
// lambda_u is read from its device pointer (no host sync).
//
// What bounds it on the card.  At B = 128 rows of D = 128 (2.1M pairs) the
// C x C product is 2.75e11 FLOPs, 1.7 ms at 495/3 TFLOP/s (3xTF32); the
// pairs' real inputs and outputs are 17 MB of U and 33.5 MB of bias, about
// 15 us at 3.35 TB/s.  The CUDA-core work (both stage-1 evaluations, 512
// GELU and two LayerNorms a pair, then 256 GELU and the projection) is of
// the same order as the products.
//
// What the design does about it: nothing but U and the bias touches device
// memory.  A block is two warpgroups of 64 pairs each (the 64 rows of a
// `wgmma` tile), the 128 consecutive pairs of the flattened (b, i, j)
// index, so any D runs without ragged tiles but the last.
//   - Stage 1 on the CUDA cores in fp32: a thread evaluates features c and
//     c + 4 of each 8 of two pairs (rows g and g + 8 of its warp), so a
//     pair's LayerNorm sums over the 4 threads of a quad; both
//     orientations are evaluated (they cost CUDA-core work, no bytes) and
//     their average x goes to shared memory, K-major in the 128-byte
//     swizzle, as the A operand of `wgmma` (64 KB a warpgroup at C = 256;
//     held in registers instead, it took 128 of them a thread and ptxas
//     spilled and serialised the products).
//   - The C x C product on the tensor cores in 3xTF32 (lo*hi + hi*lo +
//     hi*hi, summed in fp32), the split of the attention core
//     (csrc/set_attention_core.cuh: the tensor core ignores the low 13 bits
//     of a .tf32 operand, so a raw fp32 value is its own hi part; lo =
//     tf32(x - trunc(x))).  x's lo part is made in registers a slice at a
//     time; W_fc (256 KB at C = 256, more than a block's shared memory)
//     streams from L2 in slices of kN = 128 output rows x 32 inputs
//     through a TMA ring of 2 stages (all that fit beside x), and the
//     block's threads write each slice's lo part beside it while the
//     previous slice's products run.  The output columns pass in C / kN
//     passes of kN accumulators.
//   - The epilogue in registers: bias, exact GELU, the projection to H
//     summed over the quad, lambda_u; each pair's H values stored to
//     out[b, h, i, j], 8 consecutive pairs a store of a warp.
// Measured (H100 80GB HBM3, 700 W, B = 128, D = 128, C = 256): 5.9 ms
// against 27.6 ms for the plain version.  Timed with each phase left out in
// turn: stage 1 2.4 ms, the product 1.2 ms beyond the ring's own 1.7 ms
// (the slices' loads and lo parts, 16 a block), the epilogue 0.7 ms; the
// CUDA-core phases and the product do not overlap, as the two warpgroups
// take every slice together.  The alternatives that lost: x in registers
// (8.2 ms: spills, serialised products); slices of 64 outputs in 4 stages
// (7.0 ms: the SS products then read 128 bytes of shared memory a cycle);
// one warpgroup a block, two blocks an SM (6.9 ms); a persistent block with
// a third warpgroup that loads W_fc and writes its lo parts while the
// consumers pipeline their products (6.2 ms), and with the consumers on
// alternate tiles so that one's product runs under the other's stage 1
// (8.8 ms at 64 outputs a slice: each stage 1 then runs on 4 warps of the
// SM); an erf of 14 instructions in place of erff (no gain: stage 1 is not
// bound by its arithmetic).
// What it leaves for later: a slot pair of two different jets of a packed
// row is computed and then masked by the attention, as in the reference.

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;              // two warpgroups
constexpr int kPairs = 64;                 // pairs of a warpgroup: the rows of a wgmma tile
constexpr int kBlockPairs = 2 * kPairs;
constexpr int kSliceK = 32;                // inputs of a W_fc slice: one 128-byte row
constexpr int kN = 128;                    // outputs of a W_fc slice and of a pass
constexpr int kStages = 2;                 // the ring's
constexpr int kMaxHeads = 4;               // the heads a quad's lanes store, one each
constexpr int kMaxSmem = 232448;

// Shared memory from a 1024-aligned base: each warpgroup's hidden x of its
// 64 pairs (kC / 32 column blocks of 64 rows x 128 bytes, K-major in the
// 128-byte swizzle, the A operand of `wgmma`), the ring (a stage: the raw
// W_fc slice, then its lo part, kN rows of 128 bytes each, in the swizzle
// TMA writes), stage 1's (w0, w1, b1, gamma) and beta a feature, b_fc,
// W_out (kMaxHeads rows, zero past H), b_out and lambda_u, the `full`
// barriers.  At C = 256: 128 + 64 + 10 KB.
template <int kC>
struct Layout {
  static constexpr int hcol = kPairs * 128;
  static constexpr int slice = kN * 128;
  static constexpr int ring = 2 * (kC / kSliceK) * hcol;
  static constexpr int p1 = ring + kStages * 2 * slice;
  static constexpr int beta = p1 + 16 * kC;
  static constexpr int bfc = beta + 4 * kC;
  static constexpr int wout = bfc + 4 * kC;
  static constexpr int misc = wout + 4 * kMaxHeads * kC;  // b_out[kMaxHeads], lambda_u
  static constexpr int bar = misc + 32;
  static constexpr int total = bar + 8 * kStages + 1024;
};

struct Args {
  CUtensorMap wmap;  // W_fc (C, C): boxes of (32 inputs, kN outputs), 128-byte swizzle
  const float* u;    // (B, D, D, 2)
  const float* fc_w;
  const float* fc_b;
  const float* ln_w;
  const float* ln_b;
  const float* proj_b;  // (C) or null
  const float* out_w;   // (H, C)
  const float* out_b;   // (H) or null
  const float* lambda;  // ()
  float* out;           // (B, H, D, D)
  long long pairs;      // B D D
  int D, H;
  float eps;            // the LayerNorm's
};

// ------------------------------------------------ helpers (as in the core)

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// what the tensor core's truncation to TF32 drops, rounded to TF32
__device__ __forceinline__ float tf32_lo(float x) {
  return __uint_as_float(to_tf32(x - __uint_as_float(__float_as_uint(x) & 0xffffe000u)));
}

__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// exact GELU as PyTorch's CUDA kernel computes it
__device__ __forceinline__ float gelu(float x) {
  return x * 0.5f * (1.f + erff(x * static_cast<float>(M_SQRT1_2)));
}

// the byte offset `off` (from a 1024-aligned base) as the 128-byte swizzle
// places it: bits 4-6 XOR bits 7-9
__device__ __forceinline__ uint32_t swizzle(uint32_t off) { return off ^ (((off >> 7) & 7u) << 4); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// wait for the phase `parity` of `bar`; one that has not completed after
// about 2^32 cycles (2 s) is a fault, and traps
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

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// K-major operand in the 128-byte swizzle: rows of 128 bytes, 8-row groups
// 1024 bytes apart
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
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

// keep the compiler from moving or reusing registers that an in-flight
// wgmma reads or writes across the fence, commit or wait around it
template <int kRows>
__device__ __forceinline__ void fence_regs(float (&d)[kRows][4]) {
#pragma unroll
  for (int n = 0; n < kRows; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e])::"memory");
  }
}
template <int kRows>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[kRows][4]) {
#pragma unroll
  for (int n = 0; n < kRows; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[n][e])::"memory");
  }
}

#define LPM_D4(n) "+f"(d[n][0]), "+f"(d[n][1]), "+f"(d[n][2]), "+f"(d[n][3])

// d (64 x 128, fp32) += A (64 x 8 tf32, registers) B (8 x 128, K-major in shared memory)
__device__ __forceinline__ void tf32_rs(float (&d)[16][4], const uint32_t (&a)[4],
                                        uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : LPM_D4(0), LPM_D4(1), LPM_D4(2), LPM_D4(3), LPM_D4(4), LPM_D4(5), LPM_D4(6), LPM_D4(7),
        LPM_D4(8), LPM_D4(9), LPM_D4(10), LPM_D4(11), LPM_D4(12), LPM_D4(13), LPM_D4(14),
        LPM_D4(15)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 128, fp32) += A (64 x 8 tf32) B (8 x 128), both K-major in shared memory
__device__ __forceinline__ void tf32_ss(float (&d)[16][4], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : LPM_D4(0), LPM_D4(1), LPM_D4(2), LPM_D4(3), LPM_D4(4), LPM_D4(5), LPM_D4(6), LPM_D4(7),
        LPM_D4(8), LPM_D4(9), LPM_D4(10), LPM_D4(11), LPM_D4(12), LPM_D4(13), LPM_D4(14),
        LPM_D4(15)
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

#undef LPM_D4

// ------------------------------------------------------------- the kernel

// One block: pairs 128 blockIdx.x.. of the flattened (b, i, j) index, 64 a
// warpgroup; warp w of a warpgroup holds its pairs 16 w + g and 16 w + g + 8
// (g = lane / 4), as the rows of the wgmma fragments.
template <int kC>
__global__ void __launch_bounds__(kThreads, 1) lund_pair_mlp_kernel(const __grid_constant__ Args a) {
  using L = Layout<kC>;
  constexpr int kKB = kC / 8;                 // k8 blocks of the hidden
  constexpr int kKS = kC / kSliceK;           // W_fc slices a pass
  constexpr int kQ = (kC / kN) * kKS;         // W_fc slices a block
  constexpr int kS = kStages;
  constexpr int kNB = kN / 8;
  static_assert(kQ >= 2, "the ring needs two slices");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  float4* p1 = reinterpret_cast<float4*>(sm + L::p1);
  float* beta = reinterpret_cast<float*>(sm + L::beta);
  float* bfc = reinterpret_cast<float*>(sm + L::bfc);
  float* wout = reinterpret_cast<float*>(sm + L::wout);
  float* misc = reinterpret_cast<float*>(sm + L::misc);
  const uint32_t bar = base + L::bar;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const long long DD = static_cast<long long>(a.D) * a.D;
  const long long pair0 = static_cast<long long>(blockIdx.x) * kBlockPairs +
                          (warp >> 2) * kPairs + (warp & 3) * 16 + g;  // row r: + 8 r

  auto issue = [&](int q) {  // slice q: pass q / kKS, inputs 32 (q % kKS)..
    const int st = q % kS;
    const uint32_t full = bar + 8 * st;
    mbar_arrive_tx(full, L::slice);
    tma_load_2d(base + L::ring + st * 2 * L::slice, &a.wmap, full, (q % kKS) * kSliceK,
                (q / kKS) * kN);
  };
  if (tid == 0) {
    for (int st = 0; st < kS; ++st) mbar_init(bar + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int q = 0; q < kS; ++q) issue(q);
  }
  for (int f = tid; f < kC; f += kThreads) {
    p1[f] = make_float4(a.fc_w[2 * f], a.fc_w[2 * f + 1], a.fc_b[f], a.ln_w[f]);
    beta[f] = a.ln_b[f];
    bfc[f] = a.proj_b != nullptr ? a.proj_b[f] : 0.f;
  }
  for (int e = tid; e < kMaxHeads * kC; e += kThreads) {
    wout[e] = e < a.H * kC ? a.out_w[e] : 0.f;
  }
  if (tid < kMaxHeads) misc[tid] = tid < a.H && a.out_b != nullptr ? a.out_b[tid] : 0.f;
  if (tid == kMaxHeads) misc[kMaxHeads] = *a.lambda;
  __syncthreads();  // the barriers and the weights

  // Stage 1 into this warpgroup's x in shared memory (pair row lr + 8 r,
  // features 8 kb + c and 8 kb + c + 4): each orientation's GELU values in
  // registers, their LayerNorm over the quad, then the average.  A thread
  // reads back only what it wrote.
  unsigned char* xw = sm + (warp >> 2) * (kC / kSliceK) * L::hcol;
  const int lr = (warp & 3) * 16 + g;
  auto x_at = [&](int row, int f) -> float& {
    return *reinterpret_cast<float*>(xw + (f >> 5) * L::hcol + swizzle(row * 128 + (f & 31) * 4));
  };
#pragma unroll 1
  for (int r = 0; r < 2; ++r) {
    const long long p = pair0 + 8 * r;
    float2 uij = make_float2(0.f, 0.f), uji = uij;  // U[b,i,j], U[b,j,i]
    if (p < a.pairs) {
      const long long b = p / DD, rem = p - b * DD;
      const long long i = rem / a.D, j = rem - i * a.D;
      uij = *reinterpret_cast<const float2*>(a.u + 2 * p);
      uji = *reinterpret_cast<const float2*>(a.u + 2 * (b * DD + j * a.D + i));
    }
#pragma unroll 1
    for (int ev = 0; ev < 2; ++ev) {
      const float2 u = ev == 0 ? uij : uji;
      float v[kKB][2];
      float s = 0.f;
#pragma unroll
      for (int kb = 0; kb < kKB; ++kb) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float4 w = p1[8 * kb + c + 4 * q];
          v[kb][q] = gelu(fmaf(u.y, w.y, u.x * w.x) + w.z);
          s += v[kb][q];
        }
      }
      const float mean = quad_sum(s) * (1.f / kC);
      float s2 = 0.f;
#pragma unroll
      for (int kb = 0; kb < kKB; ++kb) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float d = v[kb][q] - mean;
          s2 = fmaf(d, d, s2);
        }
      }
      const float rstd = rsqrtf(quad_sum(s2) * (1.f / kC) + a.eps);
#pragma unroll
      for (int kb = 0; kb < kKB; ++kb) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int f = 8 * kb + c + 4 * q;
          const float y = (v[kb][q] - mean) * rstd * p1[f].w + beta[f];
          float& x = x_at(lr + 8 * r, f);
          if (ev == 0) x = y;
          else x = 0.5f * (x + y);
        }
      }
    }
  }
  fence_proxy_async();  // x is read by wgmma

  // the lo part of slice q beside its raw values, once it has landed
  auto split = [&](int q) {
    const int st = q % kS;
    mbar_wait(bar + 8 * st, (q / kS) & 1);
    const float4* src = reinterpret_cast<const float4*>(sm + L::ring + st * 2 * L::slice);
    float4* dst = reinterpret_cast<float4*>(sm + L::ring + st * 2 * L::slice + L::slice);
    for (int e = tid; e < L::slice / 16; e += kThreads) {
      const float4 x = src[e];
      dst[e] = make_float4(tf32_lo(x.x), tf32_lo(x.y), tf32_lo(x.z), tf32_lo(x.w));
    }
    fence_proxy_async();
  };
  split(0);
  __syncthreads();  // x and slice 0's lo part are in

  // The product a slice at a time: per 8 inputs x_lo W_hi (x_lo from
  // registers), x W_lo, x W_hi (x from shared memory: its raw values are
  // its hi part); a pass's kN outputs then go through the epilogue
  const uint32_t x_base = smem_u32(xw);
  float o[2][kMaxHeads];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int hh = 0; hh < kMaxHeads; ++hh) o[r][hh] = 0.f;
  }
  float acc[kNB][4];
#pragma unroll 1
  for (int q = 0; q < kQ; ++q) {
    const int np = q / kKS, ks = q - np * kKS;
    if (ks == 0) {
#pragma unroll
      for (int n = 0; n < kNB; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    }
    const uint32_t hi_at = base + L::ring + (q % kS) * 2 * L::slice, lo_at = hi_at + L::slice;
    const uint32_t x_at_ks = x_base + ks * L::hcol;
    uint32_t alo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = lr + 8 * (e & 1), f = 8 * kk + c + 4 * (e >> 1);
        alo[kk][e] = bits(tf32_lo(*reinterpret_cast<const float*>(
            xw + ks * L::hcol + swizzle(row * 128 + f * 4))));
      }
    }
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      tf32_rs(acc, alo[kk], desc_k_major(hi_at + 32 * kk));
      tf32_ss(acc, desc_k_major(x_at_ks + 32 * kk), desc_k_major(lo_at + 32 * kk));
      tf32_ss(acc, desc_k_major(x_at_ks + 32 * kk), desc_k_major(hi_at + 32 * kk));
    }
    wgmma_commit();
    if (q + 1 < kQ) split(q + 1);  // while the products run
    wgmma_wait_all();
    fence_regs(acc);
    fence_frags(alo);
    __syncthreads();  // both warpgroups are done with slice q; slice q + 1's lo part is in
    if (tid == 0 && q + kS < kQ) issue(q + kS);
    if (ks == kKS - 1) {
      // the pass's kN outputs: bias, GELU, their share of the projection
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) {
        const int col = np * kN + 8 * nb + 2 * c;
        const float2 bb = *reinterpret_cast<const float2*>(bfc + col);
        const float z00 = gelu(acc[nb][0] + bb.x), z01 = gelu(acc[nb][1] + bb.y);
        const float z10 = gelu(acc[nb][2] + bb.x), z11 = gelu(acc[nb][3] + bb.y);
#pragma unroll
        for (int hh = 0; hh < kMaxHeads; ++hh) {
          const float2 w = *reinterpret_cast<const float2*>(wout + hh * kC + col);
          o[0][hh] = fmaf(z01, w.y, fmaf(z00, w.x, o[0][hh]));
          o[1][hh] = fmaf(z11, w.y, fmaf(z10, w.x, o[1][hh]));
        }
      }
    }
  }

  // the quad's sums; lane c stores head c of its two pairs
  const float lam = misc[kMaxHeads];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mine = 0.f;
#pragma unroll
    for (int hh = 0; hh < kMaxHeads; ++hh) {
      const float t = quad_sum(o[r][hh]);
      mine = c == hh ? t : mine;
    }
    const long long p = pair0 + 8 * r;
    if (p < a.pairs && c < a.H) {
      const long long b = p / DD, rem = p - b * DD;
      a.out[(b * a.H + c) * DD + rem] = lam * (mine + misc[c]);
    }
  }
}

// ------------------------------------------------------------- host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
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

template <int kC>
int launch(Args& a, const float* proj_w, cudaStream_t stream) {
  using L = Layout<kC>;
  static_assert(L::total <= kMaxSmem, "the ring and the weights fit a block");
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {kC, kC};
  const cuuint64_t strides[1] = {kC * 4};
  const cuuint32_t box[2] = {kSliceK, kN};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(&a.wmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(proj_w), dims,
             strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = lund_pair_mlp_kernel<kC>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::total);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long blocks = (a.pairs + kBlockPairs - 1) / kBlockPairs;
  kernel<<<static_cast<unsigned>(blocks), kThreads, L::total, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the fused pair MLP on `stream`: u (B, D, D, 2) contiguous;
// fc_w (C, 2), fc_b, ln_w, ln_b (C); proj_w (C, C) contiguous and 16-byte
// aligned (read by TMA), proj_b (C) or null; out_w (H, C), out_b (H) or
// null; lambda_u a device scalar; out (B, H, D, D) contiguous; all fp32;
// `eps` the LayerNorm's.  C is 256, H 1 to 4.  Returns the
// launch's cudaError_t (invalid value for shapes the kernel does not take);
// the kernel is not awaited.
extern "C" int lund_pair_mlp_fwd(const float* u, const float* fc_w, const float* fc_b,
                                 const float* ln_w, const float* ln_b, const float* proj_w,
                                 const float* proj_b, const float* out_w, const float* out_b,
                                 const float* lambda, float* out, int B, int D, int C, int H,
                                 float eps, void* stream) {
  if (B <= 0 || D <= 0 || H <= 0 || H > kMaxHeads ||
      (reinterpret_cast<uintptr_t>(proj_w) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long pairs = static_cast<long long>(B) * D * D;
  if ((pairs + kBlockPairs - 1) / kBlockPairs > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{};
  a.u = u;
  a.fc_w = fc_w;
  a.fc_b = fc_b;
  a.ln_w = ln_w;
  a.ln_b = ln_b;
  a.proj_b = proj_b;
  a.out_w = out_w;
  a.out_b = out_b;
  a.lambda = lambda;
  a.out = out;
  a.pairs = pairs;
  a.D = D;
  a.H = H;
  a.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 256) return launch<256>(a, proj_w, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* lund_pair_mlp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

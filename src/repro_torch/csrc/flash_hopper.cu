// Hopper (sm_90a) flash attention for bf16, with a plain C interface loaded
// through ctypes by repro_torch/kernels/_build.py.
//
// Replaces repro/kernels/flash_attention.py, flash_attention_pallas /
//   _flash_forward / _flash_kernel (forward), for bf16 operands that TMA can
//   describe (kernels/flash_attention.py, flash_route).  f32 and other views
//   go to the CUDA-core kernel of model_kernels.cu.
//
// What it computes: out[b, h, i] = softmax_j(scale * q[b, h, i] . k[b, hk, j])
//   @ v[b, hk] with scale = Dh^-0.5, hk = h / (H / H_kv), under causal only
//   keys j <= i + S_kv - S_q; f32 scores, softmax and accumulator, the output
//   rounded once to bf16.
//
// Bound on this card: operations.  The causal work is 2*B*H*S_q*S_kv*Dh
//   flops (full attention twice that); this design issues 1.5x that on the
//   tensor cores (the split P below doubles the PV product), so its bound is
//   1.5x the causal flops over 989 TFLOP/s in bf16.  The bytes of q, k, v and
//   o once over 3.35 TB/s are far smaller at S in the thousands.
//
// Design (one block of three warpgroups per (b, h, 128 query rows), the
//   heaviest causal blocks first):
//   - Warpgroup 2 is the producer: after setmaxnreg gives its registers to
//     the consumers, one thread issues TMA loads of the Q tile once and of
//     K and V tiles of 128 keys into a ring of two stages, each completing
//     on an mbarrier; consumers release a stage through a third mbarrier.
//     4-D tensor maps over (Dh, S, heads, B) with the views' own strides
//     read [B, S, H, Dh] activations seen as [B, H, S, Dh] and the shared KV
//     head of GQA in place.  TMA zero-fills rows past S and columns past Dh,
//     so any S_q, S_kv and head dims up to 128 (padded to 64 or 128) are
//     taken; keys past S_kv are masked here.
//   - Warpgroups 0 and 1 each own 64 query rows.  S = Q K^T is
//     wgmma m64n128k16 with both operands in shared memory in TMA's 128-byte
//     swizzle (K-major), f32 accumulate.  The scale Dh^-0.5 (times log2 e,
//     for exp2) is applied to S in f32 after the product, as the plain
//     version does; a bf16 Q cannot carry it exactly.  The online softmax
//     runs on the accumulator's registers: row max over the four threads of
//     a quad by shuffles, the running sum l from the f32 p, the running max
//     starting at -1e30 (the Pallas kernel's mask value) and masked scores
//     at -inf (p = 0, as in the Pallas kernel), masks run on the tiles that
//     cross the diagonal or the end of the keys only; tiles wholly above
//     the diagonal are never loaded.  The softmax's CUDA-core work, not the tensor cores, bounds
//     this design on the card, so each p is one FFMA (scale and max folded)
//     and one ex2.approx.
//   - Split P.  The reference keeps P in f32 for the PV product; one bf16
//     rounding of P costs about 20 bf16 ulps of the output where few keys
//     cancel.  So P = P_hi + P_lo with P_hi = bf16(P), P_lo = bf16(P - P_hi),
//     built in registers in wgmma's A-fragment layout (the accumulator
//     layout of S is that layout), and O += P_hi V + P_lo V as two
//     register-A wgmma products with V read from shared memory transposed
//     (MN-major), both accumulating into the same f32 O.  P_hi + P_lo
//     carries 16 bits of P's mantissa, so the output stays within one bf16
//     rounding of the f32 result.
//   - Epilogue: O / max(l, 1e-30) rounded once to bf16 and stored straight
//     from registers, rows past S_q and columns past Dh masked, in o's own
//     strides.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;     // query rows per block: two consumer warpgroups
constexpr int kKeys = 128;     // keys per K/V tile
constexpr int kStages = 2;     // K/V ring depth
constexpr int kThreads = 384;  // consumers: warpgroups 0, 1; producer: 2
constexpr int kConsumers = 256;
constexpr int kSwizzleRow = 128;  // bytes of one swizzled row: 64 bf16
constexpr float kMask = -1e30f;   // the Pallas kernel's mask value: start of the row max

// Dynamic shared memory at padded head dim DHP (64 or 128), in bytes.  Each
// operand tile is stored as DHP / 64 column halves of [rows][64] bf16 in
// TMA's 128-byte swizzle; the swizzle atom (8 rows, 1 KB) needs 1 KB
// alignment.
template <int DHP>
struct Layout {
  static constexpr int kHalves = DHP / 64;
  static constexpr int kQBytes = kRows * DHP * 2;
  static constexpr int kTileBytes = kKeys * DHP * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;
  static constexpr int kBytes = kBar + 64 + 1024;  // barriers, alignment slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle.  lbo, sbo in bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
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

// Keep the compiler from moving reads or writes of a register that an
// in-flight wgmma reads or writes across the fence / wait around it.
__device__ __forceinline__ void pin(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void pin(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

#define WG_F8(i)                                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),     \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_F32(i) WG_F8(i), WG_F8(i + 8), WG_F8(i + 16), WG_F8(i + 24)

// d[64] (+)= A[64 x 16] B[16 x 128]; A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_F32(0), WG_F32(32)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64] += A[64 x 16] B[16 x 128]; A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : WG_F32(0), WG_F32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[32] += A[64 x 16] B[16 x 64]; A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : WG_F32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef WG_F32
#undef WG_F8

// 2^x by the special-function unit (relative error about 2^-22); the
// library's exp2f adds a range fix-up around the same instruction.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// -inf, the score of a masked key.  Spelled as a bit pattern: with a
// constant the front end folds (-INFINITY, -1e30) the compiler turned the
// mask's selects into branches, 13% slower at 4 x 2,048 on the card (0.419
// against 0.371 ms).
__device__ __forceinline__ float masked_score() { return __int_as_float(0xff800000u); }

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

template <int DHP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_hopper_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                        int H, int H_kv, int S_q, int S_kv, int Dh, int causal,
                        float scale_log2, long long osb, long long osh, long long oss,
                        int paired_store) {
  using L = Layout<DHP>;
  constexpr int NO = DHP / 2;  // output accumulators per thread
  extern __shared__ unsigned char smem_raw[];
  const uint32_t s0 = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = s0 + L::kQ, sK = s0 + L::kK, sV = s0 + L::kV;
  // barriers: 0 Q full; 1 + s K full; 3 + s V full; 5 + s stage s empty
  const uint32_t sBar = s0 + L::kBar;

  const int qblock = gridDim.x - 1 - blockIdx.x;  // heaviest blocks first
  const int q0 = qblock * kRows;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hk = h / (H / H_kv);
  const int offset = S_kv - S_q;
  const int kv_end = causal ? min(S_kv, min(q0 + kRows, S_q) + offset) : S_kv;
  const int n_tiles = (kv_end + kKeys - 1) / kKeys;

  if (threadIdx.x == 0) {
    mbar_init(sBar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(sBar + 8 * (1 + s), 1);
      mbar_init(sBar + 8 * (3 + s), 1);
      mbar_init(sBar + 8 * (5 + s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---------------- producer warpgroup ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(sBar, L::kQBytes);
      for (int c = 0; c < L::kHalves; ++c)
        tma_load(sQ + c * kRows * kSwizzleRow, &tq, sBar, 64 * c, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(sBar + 8 * (5 + s), ((t / kStages) - 1) & 1);
        const uint32_t kbar = sBar + 8 * (1 + s), vbar = sBar + 8 * (3 + s);
        mbar_expect_tx(kbar, L::kTileBytes);
        for (int c = 0; c < L::kHalves; ++c)
          tma_load(sK + s * L::kTileBytes + c * kKeys * kSwizzleRow, &tk, kbar, 64 * c,
                   t * kKeys, hk, b);
        mbar_expect_tx(vbar, L::kTileBytes);
        for (int c = 0; c < L::kHalves; ++c)
          tma_load(sV + s * L::kTileBytes + c * kKeys * kSwizzleRow, &tv, vbar, 64 * c,
                   t * kKeys, hk, b);
      }
    }
  } else {
    // ---------------- consumer warpgroups ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;  // and row0 + 8
    const int col0 = 2 * (lane % 4);  // + 8 j + {0, 1} in each 8-column chunk j
    const int wg_first_row = q0 + 64 * wg;

    float acc[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] = 0.f;
    float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f};

    mbar_wait(sBar, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const uint32_t parity = (t / kStages) & 1;
      const int kv0 = t * kKeys;

      // S = Q K^T: [64 rows] x [128 keys], f32
      float sc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] = 0.f;
      mbar_wait(sBar + 8 * (1 + s), parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DHP / 16; ++kk) {
        const uint32_t half = (kk / 4), within = (kk % 4) * 32;
        const uint32_t qa = sQ + half * kRows * kSwizzleRow + wg * 64 * kSwizzleRow + within;
        const uint32_t ka = sK + s * L::kTileBytes + half * kKeys * kSwizzleRow + within;
        wgmma_ss_n128(sc, smem_desc(qa, 16, 8 * kSwizzleRow),
                      smem_desc(ka, 16, 8 * kSwizzleRow), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < 64; ++i) pin(sc[i]);

      // online softmax on the accumulator layout: sc[4 j + 2 r + c] is row
      // row0 + 8 r, key kv0 + 8 j + col0 + c.  The row max is taken over
      // the raw scores and scaled (the scale is positive); each
      // p = 2^(s * scale_log2 - m) is one FFMA and one ex2.  A masked raw
      // score is -inf, so its p is exactly 0, as -1e30 gives it after the
      // Pallas kernel's scaling.
      const bool masked = kv0 + kKeys > S_kv ||
                          (causal && kv0 + kKeys - 1 > wg_first_row + offset);
      float mx[2] = {masked_score(), masked_score()};
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float x = sc[4 * j + 2 * r + c];
            if (masked) {
              const int key = kv0 + 8 * j + col0 + c;
              if (key >= S_kv || (causal && key > row0 + 8 * r + offset)) x = masked_score();
            }
            sc[4 * j + 2 * r + c] = x;
            mx[r] = fmaxf(mx[r], x);
          }
      float alpha[2], sum[2] = {0.f, 0.f}, neg_m[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * scale_log2);
        alpha[r] = fast_exp2(m[r] - m_new);
        m[r] = m_new;
        neg_m[r] = -m_new;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = fast_exp2(fmaf(sc[4 * j + 2 * r + c], scale_log2, neg_m[r]));
            sc[4 * j + 2 * r + c] = p;
            sum[r] += p;
          }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
      for (int j = 0; j < DHP / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 2; ++c) acc[4 * j + 2 * r + c] *= alpha[r];

      // split P into bf16 hi + lo, in the A-fragment layout: for key step kk
      // the four registers are pairs (8 kk + 0, 1) ... (8 kk + 6, 7) of sc
      uint32_t p_hi[32], p_lo[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float x = sc[2 * i], y = sc[2 * i + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
        const float2 hf = __bfloat1622float2(hi);
        p_hi[i] = bf16x2_bits(hi);
        p_lo[i] = bf16x2_bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
      }

      // O += P_hi V + P_lo V: [64 rows] x [DHP], V MN-major
      mbar_wait(sBar + 8 * (3 + s), parity);
#pragma unroll
      for (int i = 0; i < NO; ++i) pin(acc[i]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        const uint64_t dv =
            smem_desc(sV + s * L::kTileBytes + kk * 16 * kSwizzleRow,
                      kKeys * kSwizzleRow, 8 * kSwizzleRow);
        wgmma_rs(acc, p_hi + 4 * kk, dv);
        wgmma_rs(acc, p_lo + 4 * kk, dv);
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < NO; ++i) pin(acc[i]);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        pin(p_hi[i]);
        pin(p_lo[i]);
      }
      mbar_arrive(sBar + 8 * (5 + s));
    }

    // epilogue: O / l, one rounding to bf16, rows past S_q and columns past
    // Dh masked
    __nv_bfloat16* op = o + b * osb + h * osh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = row0 + 8 * r;
      if (row >= S_q) continue;
      const float denom = fmaxf(l[r], 1e-30f);
      __nv_bfloat16* orow = op + row * oss;
#pragma unroll
      for (int j = 0; j < DHP / 8; ++j) {
        const int d = 8 * j + col0;
        const float x = acc[4 * j + 2 * r] / denom, y = acc[4 * j + 2 * r + 1] / denom;
        if (paired_store && d + 1 < Dh) {
          *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(x, y);
        } else {
          if (d < Dh) orow[d] = __float2bfloat16_rn(x);
          if (d + 1 < Dh) orow[d + 1] = __float2bfloat16_rn(y);
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &status) != cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) !=
        cudaSuccess)
      p = nullptr;
#endif
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A [B, heads, S, Dh] bf16 view as a 4-D tensor map over (Dh, S, heads, B),
// boxes of 64 columns x 128 rows, 128-byte swizzle, zero fill out of range.
// Strides in elements; the caller gives every stride as a multiple of 8.
CUresult encode_map(EncodeTiledFn fn, CUtensorMap* map, const void* ptr, int B, int heads,
                    int S, int Dh, long long sb, long long sh, long long ss) {
  const cuuint64_t dims[4] = {(cuuint64_t)Dh, (cuuint64_t)S, (cuuint64_t)heads,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, kRows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int DHP>
cudaError_t launch_hopper(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                          void* o, int B, int H, int H_kv, int S_q, int S_kv, int Dh,
                          int causal, long long osb, long long osh, long long oss,
                          int paired, cudaStream_t stream) {
  const int smem = Layout<DHP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_hopper_kernel<DHP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S_q + kRows - 1) / kRows, B * H);
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)Dh));
  flash_hopper_kernel<DHP><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, H, H_kv, S_q, S_kv, Dh, causal, scale_log2, osb, osh,
      oss, paired);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v: bf16 [B, H(_kv), S, Dh] views given by element strides (batch,
// head, row), each a multiple of 8, base addresses 16-byte aligned, last
// dimension contiguous; o: bf16 [B, H, S_q, Dh] by its element strides.
// Returns a cudaError_t, or 1000 + the CUresult of a tensor map that could
// not be encoded (1999 when the driver has no cuTensorMapEncodeTiled).
int rt_flash_hopper(const void* q, const void* k, const void* v, void* o, int B, int H,
                    int H_kv, int S_q, int S_kv, int Dh, int causal, long long qsb,
                    long long qsh, long long qss, long long ksb, long long ksh, long long kss,
                    long long vsb, long long vsh, long long vss, long long osb, long long osh,
                    long long oss, void* stream) {
  if (Dh < 1 || Dh > 128 || S_q < 1 || S_kv < 1) return (int)cudaErrorInvalidValue;
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return 1999;
  CUtensorMap tq, tk, tv;
  CUresult r = encode_map(fn, &tq, q, B, H, S_q, Dh, qsb, qsh, qss);
  if (r == CUDA_SUCCESS) r = encode_map(fn, &tk, k, B, H_kv, S_kv, Dh, ksb, ksh, kss);
  if (r == CUDA_SUCCESS) r = encode_map(fn, &tv, v, B, H_kv, S_kv, Dh, vsb, vsh, vss);
  if (r != CUDA_SUCCESS) return 1000 + (int)r;
  const int paired = (Dh % 2 == 0) && (osb % 2 == 0) && (osh % 2 == 0) && (oss % 2 == 0) &&
                     (reinterpret_cast<uintptr_t>(o) % 4 == 0);
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      Dh <= 64 ? launch_hopper<64>(tq, tk, tv, o, B, H, H_kv, S_q, S_kv, Dh, causal, osb, osh,
                                   oss, paired, st)
               : launch_hopper<128>(tq, tk, tv, o, B, H, H_kv, S_q, S_kv, Dh, causal, osb,
                                    osh, oss, paired, st);
  return (int)err;
}

}  // extern "C"

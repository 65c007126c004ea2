// Hopper (sm_90a) launchers of the port's model kernels, with a plain C
// interface loaded through ctypes by repro_torch/kernels/_build.py.
//
// flash_attention: replaces repro/kernels/flash_attention.py,
//   flash_attention_pallas / _flash_forward / _flash_kernel.  Blocked
//   attention with an online softmax: running max, denominator and
//   accumulator in f32, scale Dh^-0.5 applied to q, causal offset
//   S_kv - S_q, the output rounded once to the input's type.
//   Design: one block of 256 threads per (batch, head, 64 query rows).  The
//   query tile is converted to f32 into shared memory once; K and V tiles of
//   64 keys are staged through shared memory in f32 (zero-filled past S_kv
//   and past Dh, so any S_q, S_kv and any head dim up to 128 are taken and
//   the ragged tail is masked here, not by a caller).  Each thread owns a
//   4 x 4 block of the score tile and 4 rows x Dh/16 columns of the output,
//   all products on CUDA cores in f32 (fmaf).  Causal blocks stop at the
//   last key their last row may see, and the heaviest query blocks are
//   scheduled first.  GQA reads KV head h / (H / H_kv) directly.  Strides
//   are arguments, so q/k/v/o may be [B, S, H, Dh] tensors seen as
//   [B, H, S, Dh] (last dimension contiguous).
//   Bound on this card: operations.  Causal work is 2*B*H*S_q*S_kv*Dh
//   flops (full: twice that) over 989 TFLOP/s in bf16; the bytes of q, k, v
//   and o once over 3.35 TB/s are far smaller for S in the thousands.  This
//   first version runs on the CUDA cores (67 TFLOP/s f32 peak) and, with two
//   shared-memory loads for every 2-4 FMAs, reaches a fraction of even that:
//   expect it one to two orders of magnitude above the bound.  The way to
//   the bound is bf16 wgmma with TMA-fed K/V tiles (a later change).
//
// embedding_bag: replaces repro/kernels/embedding_bag.py:41,
//   embedding_bag_pallas / _embag_kernel.  Padded int32 bags [B, L], any
//   negative entry padding; per output element an f32 sum in index order,
//   divided by max(count, 1) for mean, rounded once to the table's type
//   (f32 or bf16); 64-bit row offsets, tables of up to 2^31 - 1 rows.  Every
//   recsys lookup is this kernel with bags of one (the row back bit for bit).
//   Bound on this card: bytes.  A gather with one add per element read:
//   each gathered row once, the indices and the output, over 3.35 TB/s.
//   Rows of 2 to 100 bytes (the recsys tables) cost whole 32-byte sectors,
//   so a second reading counts every gathered row's sectors.
//   The first design gave one warp to every bag at any D, each lane
//   4 scalar columns at stride 32: at D = 10 ten lanes loaded anything, at
//   D = 1 one, and each warp waited on two dependent loads (its index, then
//   its row) with nothing else in flight.  Its time per bag barely moved
//   with D (137-165 ps a bag for D = 10..128 in bf16 on an H100 at 700 W):
//   bound by resident warps times DRAM latency, not by bytes.  The lane-group logic
//   (embedding_bag_core.cuh) does four things about it:
//   1. Lane groups sized to the row: the widest vector W of 16, 8, 4 or 2
//      bytes dividing the row and both base addresses, G = min(32, next
//      power of two of R / W) lanes a bag, 32 / G bags a warp (DLRM's 256-B
//      rows 2, AutoInt's 32 B 16, FM's 20 B 4, FM's 2 B 32); rows past 32
//      vectors loop over column chunks.
//   2. Indices loaded once and coalesced: for bags of one, a warp tile's
//      indices in one load a lane, handed out by __shfl_sync; for longer
//      bags, a group loads its bag's index row a chunk of G x P entries at
//      a time and hands it out the same way.
//   3. Several rows in flight: each lane starts U = 4 row loads through
//      the read-only path (__ldg) before its first add: U bags of one, or
//      U entries of one bag, added in index order after; and each warp
//      loads its next item's indices before it works on the current one.
//      Outputs go out as W-byte streaming stores (evict first), so they
//      do not push the table's hot rows out of L2.
//   4. A bounded grid: at most kBagWaves = 8 waves of resident blocks (the
//      occupancy API's count) stride over the warp tiles, not one warp per
//      bag, in blocks small enough that the SMs finish together.  A small
//      batch gets blocks of fewer warps, spread over the SMs.  Eight waves
//      is for FM's lookups (rows of 2 and 20 bytes): 16 waves or the whole
//      grid read 1-28% slower there, and at most 4% faster elsewhere.
//   Occupancy (ptxas -v, CUDA 12.8): 48 registers a thread for W <= 8, so
//   5 blocks of 256 threads (40 warps) an SM; 64 at W = 16, 4 blocks (32
//   warps).  The sum kernels of W = 2, 4 and 16 spill nothing; bf16 at
//   W = 8 (no main-path shape) and three mean kernels spill 8-56 bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "embedding_bag_core.cuh"

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// ---------------------------------------------------------------------------
// flash attention
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;             // query rows per block
constexpr int kBK = 64;             // keys per staged tile
constexpr int kFlashThreads = 256;  // 16 x 16 threads, 4 x 4 scores each
constexpr float kNegInf = -1e30f;   // the Pallas kernel's mask value

struct Strides {
  long long b, h, s;
};

constexpr int kPS = kBK + 4;  // P's row stride: the two row groups of a
                              // warp write to disjoint banks

// Shared memory of one block, in floats: Q [kBQ][DHP+1], K [kBK][DHP+1]
// (odd row strides: the 16 rows the score loop reads at one d lie in 16
// banks), V [kBK][DHP] and the probabilities P [kBQ][kBK+4].  Where P fits
// in K's space (DHP = 128) it reuses it once the scores are formed, so two
// blocks fit on one SM.
template <int DHP>
__host__ __device__ constexpr bool flash_p_in_k() {
  return kBQ * kPS <= kBK * (DHP + 1);
}
template <int DHP>
__host__ __device__ constexpr int flash_smem_floats() {
  return kBQ * (DHP + 1) + kBK * (DHP + 1) + kBK * DHP +
         (flash_p_in_k<DHP>() ? 0 : kBQ * kPS);
}

template <typename T, int DHP>
__global__ void __launch_bounds__(kFlashThreads, 2) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int H, int H_kv, int S_q, int S_kv, int Dh, int causal,
    float scale, Strides qs, Strides ks, Strides vs, Strides os) {
  constexpr int QS = DHP + 1;
  constexpr int PS = kPS;
  constexpr int NC = DHP / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * QS;
  float* Vs = Ks + kBK * QS;
  float* Ps = flash_p_in_k<DHP>() ? Ks : Vs + kBK * DHP;

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // score columns tx + 16c, output columns tx + 16c
  const int ty = tid >> 4;  // rows 4 ty .. 4 ty + 3
  const int qblock = gridDim.x - 1 - blockIdx.x;  // heaviest blocks first
  const int q0 = qblock * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / H_kv);
  const int offset = S_kv - S_q;

  const T* qp = q + b * qs.b + h * qs.h;
  const T* kp = k + b * ks.b + hk * ks.h;
  const T* vp = v + b * vs.b + hk * vs.h;

  for (int i = tid; i < kBQ * DHP; i += kFlashThreads) {
    const int r = i / DHP, d = i % DHP;
    const int row = q0 + r;
    Qs[r * QS + d] =
        (row < S_q && d < Dh) ? to_f32(qp[row * qs.s + d]) * scale : 0.f;
  }

  float acc[4][NC];
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  int kv_end = S_kv;
  if (causal) {
    const int last_row = min(q0 + kBQ, S_q) - 1;
    kv_end = min(S_kv, last_row + offset + 1);
  }

  for (int kv0 = 0; kv0 < kv_end; kv0 += kBK) {
    __syncthreads();  // the previous tile's P and V reads are done
    for (int i = tid; i < kBK * DHP; i += kFlashThreads) {
      const int j = i / DHP, d = i % DHP;
      const int key = kv0 + j;
      const bool in = key < S_kv && d < Dh;
      Ks[j * QS + d] = in ? to_f32(kp[key * ks.s + d]) : 0.f;
      Vs[j * DHP + d] = in ? to_f32(vp[key * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DHP; ++d) {
      float a[4], bb[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = Qs[(4 * ty + r) * QS + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) bb[c] = Ks[(tx + 16 * c) * QS + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(a[r], bb[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + 4 * ty + r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = kv0 + tx + 16 * c;
        const bool ok = key < S_kv && (!causal || key <= row + offset);
        if (!ok) s[r][c] = kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
      // the 16 threads of a row group are 16 consecutive lanes
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = expf(s[r][c] - m_new);
        sum += s[r][c];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
    }

    __syncthreads();  // every thread is done reading K (P may take its place)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) Ps[(4 * ty + r) * PS + tx + 16 * c] = s[r][c];
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float p[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) p[r] = Ps[(4 * ty + r) * PS + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = Vs[j * DHP + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(p[r], vv, acc[r][c]);
      }
    }
  }

  T* op = o + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + 4 * ty + r;
    if (row >= S_q) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < Dh) op[row * os.s + d] = from_f32<T>(acc[r][c] / denom);
    }
  }
}

template <typename T, int DHP>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* o,
                         int B, int H, int H_kv, int S_q, int S_kv, int Dh,
                         int causal, Strides qs, Strides ks, Strides vs,
                         Strides os, cudaStream_t stream) {
  const size_t smem = sizeof(float) * flash_smem_floats<DHP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DHP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S_q + kBQ - 1) / kBQ, B * H);
  const float scale = 1.0f / sqrtf((float)Dh);
  flash_attention_kernel<T, DHP><<<grid, kFlashThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H, H_kv, S_q, S_kv, Dh,
      causal, scale, qs, ks, vs, os);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_flash(const void* q, const void* k, const void* v,
                           void* o, int B, int H, int H_kv, int S_q, int S_kv,
                           int Dh, int causal, Strides qs, Strides ks,
                           Strides vs, Strides os, cudaStream_t stream) {
  if (Dh <= 16)
    return launch_flash<T, 16>(q, k, v, o, B, H, H_kv, S_q, S_kv, Dh, causal,
                               qs, ks, vs, os, stream);
  if (Dh <= 32)
    return launch_flash<T, 32>(q, k, v, o, B, H, H_kv, S_q, S_kv, Dh, causal,
                               qs, ks, vs, os, stream);
  if (Dh <= 64)
    return launch_flash<T, 64>(q, k, v, o, B, H, H_kv, S_q, S_kv, Dh, causal,
                               qs, ks, vs, os, stream);
  if (Dh <= 128)
    return launch_flash<T, 128>(q, k, v, o, B, H, H_kv, S_q, S_kv, Dh, causal,
                                qs, ks, vs, os, stream);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// embedding bag (the lane-group logic: embedding_bag_core.cuh)
// ---------------------------------------------------------------------------

constexpr int kBagThreads = 256;
constexpr int kBagWarps = kBagThreads / 32;
constexpr int kBagWaves = 8;  // grid: at most this many waves of resident blocks

// A warp-wide shuffle of an index register (every lane calls it alike).
struct WarpShfl {
  __host__ __device__ __forceinline__ int32_t operator()(int32_t v, int, int src) const {
#ifdef __CUDA_ARCH__
    return __shfl_sync(0xffffffffu, v, src);
#else
    return (void)src, v;  // never called on the host
#endif
  }
};

// Warps stride over `items` work items (eb::warp_items): tiles of bags of
// one (L == 1), or one bag a group of G lanes (any other L, 0 included).
// Each warp loads its next item's indices (its first chunk of them) before
// it works on the current item, so that round trip overlaps the rows'.
// MEAN is a template argument, so a sum kernel holds no division.
template <class T, int W, bool MEAN>
__global__ void __launch_bounds__(kBagThreads) embedding_bag_kernel(
    const uint8_t* __restrict__ table, const int32_t* __restrict__ idx,
    uint8_t* __restrict__ out, long long B, int L, long long items, eb::Plan p) {
  constexpr int U = eb::kU;
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (blockDim.x >> 5);
  long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int32_t ir[U], next[U];
  if (L == 1) {
    eb::bag1_load_indices<U>(p, idx, B, w * p.tile, lane, ir);
    for (; w < items; w += warps) {
      eb::bag1_load_indices<U>(p, idx, B, (w + warps) * p.tile, lane, next);
      eb::bag1_tile<T, W, U>(p, table, out, B, w * p.tile, MEAN, lane, ir, WarpShfl{});
#pragma unroll
      for (int r = 0; r < U; ++r) ir[r] = next[r];
    }
    return;
  }
  const int g = lane & (p.G - 1);
  const long long stride = warps * p.bpw;
  long long bag = w * p.bpw + (lane >> p.lg);
  eb::rows_load_indices<U>(p, idx, L, bag, bag < B, 0, lane, next);
  for (; w < items; w += warps, bag += stride) {
    const bool live = bag < B;
    int32_t first[U];
#pragma unroll
    for (int r = 0; r < U; ++r) first[r] = next[r];
    eb::rows_load_indices<U>(p, idx, L, bag + stride, bag + stride < B, 0, lane, next);
    for (int c = 0; c < p.chunks; ++c) {
      const int col = c * p.G + g;
      const bool on = live && col < p.nvec;
      float acc[eb::elems<T, W>()];
#pragma unroll
      for (int e = 0; e < eb::elems<T, W>(); ++e) acc[e] = 0.f;
      int count = 0;
      for (int t0 = 0; t0 < L; t0 += p.chunk) {
        if (c == 0 && t0 == 0) {
#pragma unroll
          for (int r = 0; r < U; ++r) ir[r] = first[r];
        } else {
          eb::rows_load_indices<U>(p, idx, L, bag, live, t0, lane, ir);
        }
        eb::rows_chunk<T, W, U>(p, table, col, on, lane, ir, acc, count, WarpShfl{});
      }
      if (on) eb::finish<T, W>(out + bag * p.R + (long long)col * W, acc, count, MEAN);
    }
  }
}

// The grid: blocks of up to kBagWarps warps, fewer while the work would fill
// fewer than one block an SM (a small batch spreads over the SMs), and at
// most kBagWaves waves of resident blocks (the occupancy API's count).
template <class T, int W, bool MEAN>
cudaError_t launch_bag_plan(const void* table, const void* idx, void* out, int B, int L,
                            const eb::Plan& p, cudaStream_t stream) {
  static int per_sm = 0;  // resident blocks of kBagThreads an SM
  cudaError_t err = cudaSuccess;
  if (per_sm == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, embedding_bag_kernel<T, W, MEAN>, kBagThreads, 0);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long items = eb::warp_items(p, B, L);
  int wpb = kBagWarps;
  while (wpb > 1 && items < (long long)sms * wpb) wpb >>= 1;
  const long long need = (items + wpb - 1) / wpb;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1) * kBagWaves;
  const unsigned blocks = (unsigned)(need < resident ? need : resident);
  embedding_bag_kernel<T, W, MEAN><<<blocks, wpb * 32, 0, stream>>>(
      (const uint8_t*)table, (const int32_t*)idx, (uint8_t*)out, B, L, items, p);
  return cudaGetLastError();
}

template <class T>
cudaError_t launch_bag(const void* table, const void* idx, void* out, int B, int L, int D,
                       int mean, cudaStream_t stream) {
  if (B == 0 || D == 0) return cudaSuccess;
  const eb::Plan p = eb::make_plan(D, T::kBytes, (uintptr_t)table, (uintptr_t)out);
  const int err = eb::with_plan<T>(p, [&](auto w) {
    constexpr int W = decltype(w)::value;
    return (int)(mean ? launch_bag_plan<T, W, true>(table, idx, out, B, L, p, stream)
                      : launch_bag_plan<T, W, false>(table, idx, out, B, L, p, stream));
  });
  return err < 0 ? cudaErrorInvalidValue : (cudaError_t)err;
}

}  // namespace

extern "C" {

// q, k, v, o: [B, H(_kv), S, Dh] views given by element strides (batch,
// head, row); the last dimension is contiguous.  is_bf16: 1 for bf16, 0 for
// f32.  Returns a cudaError_t (cudaErrorInvalidValue for Dh > 128).
int rt_flash_attention(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int H_kv, int S_q, int S_kv, int Dh,
                       int causal, int is_bf16, long long qsb, long long qsh,
                       long long qss, long long ksb, long long ksh,
                       long long kss, long long vsb, long long vsh,
                       long long vss, long long osb, long long osh,
                       long long oss, void* stream) {
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  cudaError_t err =
      is_bf16 ? dispatch_flash<__nv_bfloat16>(q, k, v, o, B, H, H_kv, S_q,
                                              S_kv, Dh, causal, qs, ks, vs, os,
                                              (cudaStream_t)stream)
              : dispatch_flash<float>(q, k, v, o, B, H, H_kv, S_q, S_kv, Dh,
                                      causal, qs, ks, vs, os,
                                      (cudaStream_t)stream);
  return (int)err;
}

// table [V, D] (f32 or bf16), idx int32 [B, L] with -1 padding, out [B, D]
// in the table's type.  mean: 1 for "mean", 0 for "sum".
int rt_embedding_bag(const void* table, const void* idx, void* out, int B,
                     int L, int D, int mean, int is_bf16, void* stream) {
  cudaError_t err =
      is_bf16 ? launch_bag<eb::BF16>(table, idx, out, B, L, D, mean, (cudaStream_t)stream)
              : launch_bag<eb::F32>(table, idx, out, B, L, D, mean, (cudaStream_t)stream);
  return (int)err;
}

}  // extern "C"

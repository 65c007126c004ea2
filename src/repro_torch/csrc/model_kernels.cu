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
// embedding_bag: replaces repro/kernels/embedding_bag.py,
//   embedding_bag_pallas / _embag_kernel.  One warp per bag, lanes over the
//   D columns; each lane accumulates in f32 in index order, skips -1 (any
//   negative) entries, divides by max(count, 1) for mean, and rounds once
//   to the table's type.  Row offsets are 64-bit, so tables of up to
//   2^31 - 1 rows are taken.
//   Bound on this card: bytes — each gathered row once, the index matrix
//   and the output; one or two adds per element read.  Rows are read as
//   whole coalesced lines; the warp streams its bag's rows one after the
//   other and the many resident warps keep enough reads in flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// embedding bag
// ---------------------------------------------------------------------------

constexpr int kBagThreads = 256;  // 8 bags per block
constexpr int kColsPerLane = 4;   // one pass covers 128 columns

template <typename T>
__global__ void embedding_bag_kernel(const T* __restrict__ table,
                                     const int32_t* __restrict__ idx,
                                     T* __restrict__ out, int B, int L, int D,
                                     int mean) {
  const long long bag =
      ((long long)blockIdx.x * kBagThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (bag >= B) return;
  const int32_t* bag_idx = idx + bag * L;
  T* bag_out = out + bag * D;
  for (int c0 = 0; c0 < D; c0 += 32 * kColsPerLane) {
    float acc[kColsPerLane];
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) acc[j] = 0.f;
    int count = 0;
    for (int t = 0; t < L; ++t) {
      const int32_t row = bag_idx[t];
      if (row < 0) continue;
      ++count;
      const T* rp = table + (long long)row * D;
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const int c = c0 + lane + 32 * j;
        if (c < D) acc[j] += to_f32(rp[c]);
      }
    }
    const float denom = (float)max(count, 1);
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      const int c = c0 + lane + 32 * j;
      if (c < D) bag_out[c] = from_f32<T>(mean ? acc[j] / denom : acc[j]);
    }
  }
}

template <typename T>
cudaError_t launch_bag(const void* table, const void* idx, void* out, int B,
                       int L, int D, int mean, cudaStream_t stream) {
  const long long blocks = ((long long)B * 32 + kBagThreads - 1) / kBagThreads;
  embedding_bag_kernel<T><<<(unsigned)blocks, kBagThreads, 0, stream>>>(
      (const T*)table, (const int32_t*)idx, (T*)out, B, L, D, mean);
  return cudaGetLastError();
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
      is_bf16 ? launch_bag<__nv_bfloat16>(table, idx, out, B, L, D, mean,
                                          (cudaStream_t)stream)
              : launch_bag<float>(table, idx, out, B, L, D, mean,
                                  (cudaStream_t)stream);
  return (int)err;
}

}  // extern "C"

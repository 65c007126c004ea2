// Hopper (sm_90a) launchers of the port's four kernels, with a plain C
// interface loaded through ctypes by repro_torch/kernels/_build.py.
//
// backward_search: replaces repro/kernels/backward_search.py,
//   backward_search_pallas / _backward_search_kernel.  One thread per query
//   walks its symbols right to left and descends every wavelet level with
//   both range ends.  Bound on this card: device-memory latency and bytes —
//   each level costs two dependent 4-byte word reads and two prefix reads at
//   data-dependent addresses (one 32-byte sector each), with almost no
//   arithmetic.  The wavelet matrix is read through the read-only cache
//   (__ldg); at n = 1M it fits in L2, at 16M it does not.
//
// ilcp_list: replaces repro/kernels/ilcp_list.py, ilcp_list_pallas /
//   _ilcp_list_kernel.  One thread per query runs the Fig-1 recursion
//   directly (the Pallas POP/SCAN lockstep machine exists for TPU SIMD and
//   is not carried over); its interval stacks and seen-document bitmap live
//   in global scratch allocated by the wrapper.  Bound on this card:
//   latency of the dependent RMQ -> run -> DA gather chain, one query per
//   thread with divergent trip counts.
//
// rank: replaces repro/kernels/rank.py, rank_pallas / _rank_kernel.  One
//   thread per query: one word and one prefix read at a data-dependent
//   address (rt::wm_rank1, the helper the fused backward search uses), a
//   masked popcount, one coalesced int32 write.  Bound on this card: bytes
//   and latency of the scattered reads; the query stream itself is read and
//   written coalesced.
//
// rmq: replaces repro/kernels/rmq.py, rmq_pallas / _rmq_kernel.  One thread
//   per query: two sparse-table reads and two value reads (rt::rmq_leftmost,
//   the helper the fused ILCP listing uses).  Bound on this card: bytes and
//   latency of those four dependent, scattered reads.
//
// All four are first versions that are simple and right.  Making them fast
// (cp.async/TMA staging of the wavelet levels, one warp per query with a
// cooperative traversal, shared-memory stacks) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "retrieval_core.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void backward_search_kernel(
    const int32_t* __restrict__ words, const int32_t* __restrict__ prefix,
    const int32_t* __restrict__ zcount, const int32_t* __restrict__ base,
    const int32_t* __restrict__ patterns, const int32_t* __restrict__ lengths,
    int32_t* __restrict__ lo, int32_t* __restrict__ hi, int B, int max_m,
    int levels, int stride, int n, int sigma) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= B) return;
  rt::backward_search_one(words, prefix, zcount, base, levels, stride, n,
                          sigma, patterns + (int64_t)q * max_m, max_m,
                          lengths[q], lo + q, hi + q);
}

__global__ void ilcp_list_kernel(
    const int32_t* __restrict__ vilcp, const int32_t* __restrict__ table,
    const int32_t* __restrict__ run_starts, const int32_t* __restrict__ da,
    const int32_t* __restrict__ lo, const int32_t* __restrict__ hi,
    const int32_t* __restrict__ lo_run, const int32_t* __restrict__ hi_run,
    int32_t* __restrict__ stka, int32_t* __restrict__ stkb,
    uint32_t* __restrict__ seen, int32_t* __restrict__ docs,
    int32_t* __restrict__ cnt, int B, int levels, int rho, int n, int d,
    int max_df, int seen_words) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= B) return;
  const int cap = rt::stack_cap(max_df);
  cnt[q] = rt::ilcp_list_one(
      vilcp, table, run_starts, da, levels, rho, n, d, max_df, lo[q], hi[q],
      lo_run[q], hi_run[q], stka + (int64_t)q * cap, stkb + (int64_t)q * cap,
      seen + (int64_t)q * seen_words, docs + (int64_t)q * max_df);
}

__global__ void rank_kernel(const int32_t* __restrict__ words,
                            const int32_t* __restrict__ prefix,
                            const int32_t* __restrict__ idx,
                            int32_t* __restrict__ out, int Q) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  out[q] = rt::wm_rank1(words, prefix, 0, 0, idx[q]);
}

__global__ void rmq_kernel(const int32_t* __restrict__ values,
                           const int32_t* __restrict__ table,
                           const int32_t* __restrict__ lo,
                           const int32_t* __restrict__ hi,
                           int32_t* __restrict__ out, int Q, int levels,
                           int rho) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  out[q] = rt::rmq_leftmost(table, values, levels, rho, lo[q], hi[q]);
}

int blocks_for(int B) { return (B + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

int rt_backward_search(const void* words, const void* prefix,
                       const void* zcount, const void* base,
                       const void* patterns, const void* lengths, void* lo,
                       void* hi, int B, int max_m, int levels, int stride,
                       int n, int sigma, void* stream) {
  backward_search_kernel<<<blocks_for(B), kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const int32_t*)words, (const int32_t*)prefix, (const int32_t*)zcount,
      (const int32_t*)base, (const int32_t*)patterns,
      (const int32_t*)lengths, (int32_t*)lo, (int32_t*)hi, B, max_m, levels,
      stride, n, sigma);
  return (int)cudaGetLastError();
}

int rt_ilcp_list(const void* vilcp, const void* table, const void* run_starts,
                 const void* da, const void* lo, const void* hi,
                 const void* lo_run, const void* hi_run, void* stka,
                 void* stkb, void* seen, void* docs, void* cnt, int B,
                 int levels, int rho, int n, int d, int max_df,
                 int seen_words, void* stream) {
  ilcp_list_kernel<<<blocks_for(B), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)vilcp, (const int32_t*)table,
      (const int32_t*)run_starts, (const int32_t*)da, (const int32_t*)lo,
      (const int32_t*)hi, (const int32_t*)lo_run, (const int32_t*)hi_run,
      (int32_t*)stka, (int32_t*)stkb, (uint32_t*)seen, (int32_t*)docs,
      (int32_t*)cnt, B, levels, rho, n, d, max_df, seen_words);
  return (int)cudaGetLastError();
}

int rt_rank(const void* words, const void* prefix, const void* idx,
            void* out, int Q, void* stream) {
  rank_kernel<<<blocks_for(Q), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)words, (const int32_t*)prefix, (const int32_t*)idx,
      (int32_t*)out, Q);
  return (int)cudaGetLastError();
}

int rt_rmq(const void* values, const void* table, const void* lo,
           const void* hi, void* out, int Q, int levels, int rho,
           void* stream) {
  rmq_kernel<<<blocks_for(Q), kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)values, (const int32_t*)table, (const int32_t*)lo,
      (const int32_t*)hi, (int32_t*)out, Q, levels, rho);
  return (int)cudaGetLastError();
}

}  // extern "C"

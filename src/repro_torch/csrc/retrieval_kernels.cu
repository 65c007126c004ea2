// Hopper (sm_90a) launchers of the port's seven retrieval kernels, with a plain C
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
//   _ilcp_list_kernel.  One warp per query runs the Fig-1 recursion (the
//   Pallas POP/SCAN lockstep machine exists for TPU SIMD and is not carried
//   over).  Bound on this card: latency of the dependent pop -> run -> DA
//   chain, not bytes.  The design shortens that chain: the interval stack
//   (with each interval's argmin, resolved when it is pushed, the two
//   children's RMQs issued by lanes 0 and 1 beside the run's reads) and the
//   seen-document bitmap live in shared memory; the run's DA positions are
//   read 32 at a time, one per lane, and tested against the bitmap and each
//   other (__match_any_sync) at once; the query's root runs are found in the
//   kernel.  A pop costs two dependent global reads (run_starts, then DA).
//
// pdl_gather: the port's own kernel (the reference's PDL gather,
//   repro/core/pdl.py _pdl_gather, is XLA, not Pallas).  One block of
//   kGatherThreads threads per query walks the query's cover together
//   (rt::pdl_gather_block): the partial-block windows' CSA locates (up to
//   2 x (block_size - 1) LF walks) spread over every thread; then, a chunk
//   of kGatherThreads leaves at a time, every thread climbs one leaf from
//   the chain's head speculatively, one __syncthreads_and finds the common
//   chain where every climb ends at the leaf after it (else lane 0 follows
//   the links in shared memory), and a block scan of the members' list
//   sizes (doc_base) gives each member its slots; the members of up to
//   rt::kPdlRounds chunks are then expanded side by side, each thread
//   taking the next member from a shared counter when its last is done,
//   with its own grammar stack (shared memory, interleaved so that a
//   warp's stack slots fall in distinct banks); last, top-k entries'
//   global positions become frequencies (one binary search per entry) and
//   the row's tail is zeroed.  Bound on this card: latency, not bytes: per
//   chunk a climb's dependent reads, the chain and the scan, and per
//   expansion phase the longest member's expansion, one dependent read of
//   a list symbol or a rule's children per step.  A node's expansion stays
//   serial: where one node holds most of a query's entries (the top-k
//   PDL's internal nodes), that node is the kernel's time.

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
// sada_c_list: the port's own kernel (the reference's sada_c_list_docs,
//   repro/core/listing.py, is XLA: the paper's Sada-C baseline).  One warp
//   per query, one query a block, runs Sadakane's RMQ recursion over C
//   (rt::sada_c_list_one); DA[k] from a stored array (Sada-C-D) or by a CSA
//   locate (Sada-C-L), one template each.  Bound on this card: latency of
//   the dependent RMQ (table, then values) -> DA chain, one per reported
//   document, and of L1: the chain's reads miss it once it is crowded.
//   The design shortens the chain as the ILCP kernel's does: each stack
//   entry holds its interval's argmin and document, resolved when it is
//   pushed, so a pop reads only shared memory (its seen test included) and
//   a pruned or invalid pop costs no global read; a reported pop's two
//   children are resolved side by side, one per half-warp; a stored DA is
//   read at both RMQ candidates beside their values (two rounds, not
//   three); on the CSA each binary search of the locate (the sampled test
//   of every LF step, the sample's rank, the document start) is a 16-way
//   search by the half-warp, one pivot per lane and a ballot a round
//   (rt::group_search), 4 rounds over the samples instead of 17.  The
//   warp's stack and bitmap (about 5 KB at max_df 321) are the block's
//   shared memory, and the launch asks for the L1/shared split with the
//   most L1.
//
// ilcp_list also runs Sada-I-L: the same kernel instantiated on the CSA
//   locate (rt::DaLocate), each lane of the warp locating its own position
//   of a run's 32-position chunk.
//
// wt_list: the port's own kernel (the reference's wt_list_docs,
//   repro/core/wtlist.py, is XLA: the WT baseline).  One thread per query
//   runs the left-first DFS over the DA wavelet matrix (rt::wt_list_one) with
//   a stack of levels + 2 entries in local memory.  Bound on this card:
//   latency, one dependent word-and-prefix read per internal node, at most
//   df (levels + 1) nodes a query.
//
// backward_search, rank, rmq and wt_list are first versions that are simple
// and right; cp.async/TMA staging of the wavelet levels and a warp per
// query for the WT lister are later work.  Like every kernel here, this
// code is compiled and run only on the card (chip_smoke.py, the scripts);
// the host builds of retrieval_core.cuh check the cores' arithmetic.

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

template <class Src>
__global__ void ilcp_list_kernel(
    const int32_t* __restrict__ vilcp, const int32_t* __restrict__ table,
    const int32_t* __restrict__ run_starts, const Src src,
    const int32_t* __restrict__ lo, const int32_t* __restrict__ hi,
    int32_t* __restrict__ docs, int32_t* __restrict__ cnt, int levels,
    int rho, int d, int max_df) {
  extern __shared__ int32_t smem[];
  const int q = blockIdx.x;
  const int cap = rt::stack_cap(max_df);
  const int a = lo[q], b = hi[q];
  const int c = rt::ilcp_list_one(
      vilcp, table, run_starts, src, levels, rho, d, max_df, a, b,
      rt::run_of(run_starts, rho, a), rt::run_of(run_starts, rho, b - 1),
      smem, smem + cap, smem + 2 * cap,
      reinterpret_cast<uint32_t*>(smem + 3 * cap), docs + (int64_t)q * max_df);
  if (threadIdx.x == 0) cnt[q] = c;
}

// One warp per query, blockDim.x / kWarp queries per block; each warp's
// stack and seen bitmap in its own slice of rt::sada_c_shared_ints ints.
template <class Src>
__global__ void sada_c_list_kernel(
    const int32_t* __restrict__ table, const int32_t* __restrict__ values,
    const Src src, const int32_t* __restrict__ lo, const int32_t* __restrict__ hi,
    int32_t* __restrict__ docs, int32_t* __restrict__ cnt, int B, int levels,
    int n, int d, int max_df) {
  extern __shared__ int32_t smem[];
  const int w = threadIdx.x / rt::kWarp;
  const int q = blockIdx.x * (blockDim.x / rt::kWarp) + w;
  if (q >= B) return;
  int32_t* slice = smem + (int64_t)w * rt::sada_c_shared_ints(d, max_df);
  const int c = rt::sada_c_list_one(
      table, values, levels, n, src, d, max_df, lo[q], hi[q], slice,
      reinterpret_cast<uint32_t*>(slice + 4 * rt::stack_cap(max_df)),
      docs + (int64_t)q * max_df);
  if (rt::lane_id() == 0) cnt[q] = c;
}

constexpr int kWtThreads = 32;

__global__ void wt_list_kernel(
    const int32_t* __restrict__ words, const int32_t* __restrict__ prefix,
    const int32_t* __restrict__ zcount, const int32_t* __restrict__ lo,
    const int32_t* __restrict__ hi, int32_t* __restrict__ docs,
    int32_t* __restrict__ freqs, int32_t* __restrict__ cnt, int B, int levels,
    int stride, int max_df) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= B) return;
  cnt[q] = rt::wt_list_one(words, prefix, zcount, levels, stride, lo[q], hi[q], max_df,
                           docs + (int64_t)q * max_df, freqs + (int64_t)q * max_df,
                           nullptr, nullptr);
}

constexpr int kGatherThreads = 256;

__global__ void __launch_bounds__(kGatherThreads, 1) pdl_gather_kernel(
    const rt::CsaView csa, const rt::PdlView pdl, const int32_t* __restrict__ lo,
    const int32_t* __restrict__ hi, int32_t* __restrict__ buf,
    int32_t* __restrict__ fbuf, int32_t* __restrict__ count, int max_buf,
    int max_cover) {
  extern __shared__ int32_t smem[];  // rt::PdlScratch for kGatherThreads leaves
  const int q = blockIdx.x;
  const int c = rt::pdl_gather_block(
      csa, pdl, lo[q], hi[q], max_buf, max_cover, kGatherThreads,
      buf + (int64_t)q * max_buf, fbuf + (int64_t)q * max_buf,
      rt::pdl_scratch(smem, kGatherThreads), threadIdx.x, kGatherThreads);
  if (threadIdx.x == 0) count[q] = c;
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

rt::CsaView csa_view(const void* words, const void* prefix, const void* zcount,
                     const void* counts, const void* sym_starts, const void* sampled,
                     const void* samples, const void* doc_starts, int levels,
                     int stride, int n, int sample_rate, int sampled_len,
                     int sampled_m, int doc_len) {
  return rt::CsaView{
      (const int32_t*)words, (const int32_t*)prefix, (const int32_t*)zcount,
      (const int32_t*)counts, (const int32_t*)sym_starts,
      (const int32_t*)sampled, (const int32_t*)samples,
      (const int32_t*)doc_starts, levels, stride, n, sample_rate,
      sampled_len, sampled_m, doc_len};
}

// Raises the kernel's dynamic shared memory limit above 48 KB when `smem`
// needs it; a card that cannot give it returns the error.
template <class Kernel>
cudaError_t allow_shared(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// Shared memory per query of the ILCP listing: three interval stacks and
// the seen bitmap.
template <class Src>
int launch_ilcp_list(const void* vilcp, const void* table, const void* run_starts,
                     const Src& src, const void* lo, const void* hi, void* docs,
                     void* cnt, int B, int levels, int rho, int d, int max_df,
                     void* stream) {
  const size_t smem =
      sizeof(int32_t) * (3 * (size_t)rt::stack_cap(max_df) + (d + 31) / 32);
  const cudaError_t e = allow_shared(ilcp_list_kernel<Src>, smem);
  if (e != cudaSuccess) return (int)e;
  ilcp_list_kernel<Src><<<B, rt::kWarp, smem, (cudaStream_t)stream>>>(
      (const int32_t*)vilcp, (const int32_t*)table, (const int32_t*)run_starts, src,
      (const int32_t*)lo, (const int32_t*)hi, (int32_t*)docs, (int32_t*)cnt, levels,
      rho, d, max_df);
  return (int)cudaGetLastError();
}

// Shared memory per warp of the Sada-C listing: the interval stack and the
// seen bitmap; `warps` queries per block (the wrapper passes 1: more share
// one SM's L1, and four took 1.04x one's time).  The kernel's reads are L1-bound, so it asks for the
// L1/shared split with the most L1 (CUDA still gives the shared
// memory a block needs): at the default split, two queries an SM took
// 1.7x one's time on the CSA locate.
template <class Src>
int launch_sada_c_list(const void* table, const void* values, const Src& src,
                       const void* lo, const void* hi, void* docs, void* cnt, int B,
                       int levels, int n, int d, int max_df, int warps, void* stream) {
  const size_t smem =
      sizeof(int32_t) * (size_t)warps * (size_t)rt::sada_c_shared_ints(d, max_df);
  cudaError_t e = allow_shared(sada_c_list_kernel<Src>, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(sada_c_list_kernel<Src>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxL1);
  if (e != cudaSuccess) return (int)e;
  sada_c_list_kernel<Src><<<(B + warps - 1) / warps, warps * rt::kWarp, smem,
                            (cudaStream_t)stream>>>(
      (const int32_t*)table, (const int32_t*)values, src, (const int32_t*)lo,
      (const int32_t*)hi, (int32_t*)docs, (int32_t*)cnt, B, levels, n, d, max_df);
  return (int)cudaGetLastError();
}

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

// The wrapper checks the shared memory against the card's limit before the
// launch.  Sada-I-D: DA read from a stored array.
int rt_ilcp_list(const void* vilcp, const void* table, const void* run_starts,
                 const void* da, const void* lo, const void* hi, void* docs,
                 void* cnt, int B, int levels, int rho, int n, int d,
                 int max_df, void* stream) {
  return launch_ilcp_list(vilcp, table, run_starts, rt::DaStored{(const int32_t*)da, n},
                          lo, hi, docs, cnt, B, levels, rho, d, max_df, stream);
}

// Sada-I-L: the CSA's operands in the order of rt::CsaView (pointers, then
// sizes), then the listing's; each lane locates its own position.
int rt_ilcp_list_csa(
    const void* words, const void* prefix, const void* zcount, const void* counts,
    const void* sym_starts, const void* sampled, const void* samples,
    const void* doc_starts, const void* vilcp, const void* table,
    const void* run_starts, const void* lo, const void* hi, void* docs, void* cnt,
    int csa_levels, int stride, int n, int sample_rate, int sampled_len,
    int sampled_m, int doc_len, int B, int levels, int rho, int d, int max_df,
    void* stream) {
  const rt::DaLocate src{csa_view(words, prefix, zcount, counts, sym_starts, sampled,
                                  samples, doc_starts, csa_levels, stride, n,
                                  sample_rate, sampled_len, sampled_m, doc_len)};
  return launch_ilcp_list(vilcp, table, run_starts, src, lo, hi, docs, cnt, B, levels,
                          rho, d, max_df, stream);
}

// Sada-C-D: the RMQ table and values over C ([levels, n], [n]) and DA; `warps`
// queries per block.
int rt_sada_c_list(const void* table, const void* values, const void* da,
                   const void* lo, const void* hi, void* docs, void* cnt, int B,
                   int levels, int n, int d, int max_df, int warps, void* stream) {
  return launch_sada_c_list(table, values, rt::DaStored{(const int32_t*)da, n}, lo, hi,
                            docs, cnt, B, levels, n, d, max_df, warps, stream);
}

// Sada-C-L: the CSA's operands as for rt_ilcp_list_csa, then the RMQ's.
int rt_sada_c_list_csa(
    const void* words, const void* prefix, const void* zcount, const void* counts,
    const void* sym_starts, const void* sampled, const void* samples,
    const void* doc_starts, const void* table, const void* values, const void* lo,
    const void* hi, void* docs, void* cnt, int csa_levels, int stride, int n,
    int sample_rate, int sampled_len, int sampled_m, int doc_len, int B, int levels,
    int d, int max_df, int warps, void* stream) {
  const rt::DaLocate src{csa_view(words, prefix, zcount, counts, sym_starts, sampled,
                                  samples, doc_starts, csa_levels, stride, n,
                                  sample_rate, sampled_len, sampled_m, doc_len)};
  return launch_sada_c_list(table, values, src, lo, hi, docs, cnt, B, levels, n, d,
                            max_df, warps, stream);
}

// WT: the DA wavelet matrix's levels ([levels, stride] words and prefix,
// [levels] zero counts); docs, freqs: [B, max_df].
int rt_wt_list(const void* words, const void* prefix, const void* zcount,
               const void* lo, const void* hi, void* docs, void* freqs, void* cnt,
               int B, int levels, int stride, int max_df, void* stream) {
  wt_list_kernel<<<(B + kWtThreads - 1) / kWtThreads, kWtThreads, 0,
                   (cudaStream_t)stream>>>(
      (const int32_t*)words, (const int32_t*)prefix, (const int32_t*)zcount,
      (const int32_t*)lo, (const int32_t*)hi, (int32_t*)docs, (int32_t*)freqs,
      (int32_t*)cnt, B, levels, stride, max_df);
  return (int)cudaGetLastError();
}

// Operands in the order of rt::CsaView and rt::PdlView (pointers, then
// sizes), the query ranges and the outputs (buf, fbuf: [B, max_buf];
// count: [B]).  Shared memory: the block's rt::PdlScratch, whose grammar
// stacks (stack_size per thread) are most of it; above 48 KB the kernel's
// limit is raised, and a card that cannot give it returns the error.
int rt_pdl_gather(
    const void* words, const void* prefix, const void* zcount,
    const void* counts, const void* sym_starts, const void* sampled,
    const void* samples, const void* doc_starts, const void* leaf_starts,
    const void* is_first_child, const void* parent_of, const void* next_leaf,
    const void* set_off, const void* A, const void* rule_left,
    const void* rule_right, const void* doc_base, const void* freq_vals,
    const void* freq_gcum, const void* lo, const void* hi, void* buf,
    void* fbuf, void* count, int levels, int stride, int n, int sample_rate,
    int sampled_len, int sampled_m, int doc_len, int L, int I, int d,
    int lenA, int nrule, int nruns, int block_size, int iter_cap,
    int stack_size, int has_freqs, int B, int max_buf, int max_cover,
    void* stream) {
  const rt::CsaView csa = csa_view(words, prefix, zcount, counts, sym_starts, sampled,
                                   samples, doc_starts, levels, stride, n, sample_rate,
                                   sampled_len, sampled_m, doc_len);
  const rt::PdlView pdl{
      (const int32_t*)leaf_starts, (const uint8_t*)is_first_child,
      (const int32_t*)parent_of, (const int32_t*)next_leaf,
      (const int32_t*)set_off, (const int32_t*)A, (const int32_t*)rule_left,
      (const int32_t*)rule_right, (const int32_t*)doc_base,
      (const int32_t*)freq_vals, (const int32_t*)freq_gcum, L, I, d, lenA,
      nrule, nruns, block_size, iter_cap, stack_size, has_freqs};
  const size_t smem =
      sizeof(int32_t) * (size_t)rt::pdl_scratch_ints(kGatherThreads, stack_size);
  const cudaError_t e = allow_shared(pdl_gather_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  pdl_gather_kernel<<<B, kGatherThreads, smem, (cudaStream_t)stream>>>(
      csa, pdl, (const int32_t*)lo, (const int32_t*)hi, (int32_t*)buf,
      (int32_t*)fbuf, (int32_t*)count, max_buf, max_cover);
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

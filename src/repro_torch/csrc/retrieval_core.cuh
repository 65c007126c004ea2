// Per-query cores of the port's Hopper kernels, written once as
// __host__ __device__ functions: nvcc compiles them into the __global__
// launchers of retrieval_kernels.cu, and a host C++ compiler compiles the
// same code (with the macros below) for the core's CPU test.
//
// Layouts follow the reference's operands: wavelet words are int32 bit
// patterns of the reference's uint32 words, every other array is int32,
// and every 2-D array is row-major.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define RT_HD __host__ __device__ __forceinline__
#else
#define RT_HD inline
#endif

// Device intrinsics in the device pass, compiler builtins in every host pass.
#ifdef __CUDA_ARCH__
#define RT_LDG(p) __ldg(p)
#define RT_POPC(x) __popc(x)
#define RT_CLZ(x) __clz(x)
#else
#define RT_LDG(p) (*(p))
#define RT_POPC(x) __builtin_popcount(x)
#define RT_CLZ(x) __builtin_clz(x)
#endif

namespace rt {

RT_HD int imin(int a, int b) { return a < b ? a : b; }
RT_HD int imax(int a, int b) { return a > b ? a : b; }
RT_HD int iclamp(int x, int lo, int hi) { return imin(imax(x, lo), hi); }

// ---------------------------------------------------------------------------
// Backward search (replaces repro/kernels/backward_search.py,
// _backward_search_kernel): one query, natural left-to-right pattern row.
// ---------------------------------------------------------------------------

// Ones in bits [0, pos) of level `lvl`: prefix of whole words + popcount of
// the masked partial word.  One word and one prefix read per call.  The
// mask is computed unsigned: pos % 32 == 0 gives 0.  Also the whole of the
// batched rank kernel (repro/kernels/rank.py, _rank_kernel), with lvl = 0.
RT_HD int wm_rank1(const int32_t* words, const int32_t* prefix, int stride,
                   int lvl, int pos) {
  const int64_t w = (int64_t)lvl * stride + (pos >> 5);
  const uint32_t mask = (1u << (pos & 31)) - 1u;
  const uint32_t word = (uint32_t)RT_LDG(words + w);
  return RT_LDG(prefix + w) + RT_POPC(word & mask);
}

// Right to left over pattern[0:length]; both range ends share one descent
// per symbol step.  A symbol outside [0, sigma) collapses the range to 0 or
// n; a length-0 row keeps (0, n).  Writes (lo, max(lo, hi)).
RT_HD void backward_search_one(
    const int32_t* words, const int32_t* prefix, const int32_t* zcount,
    const int32_t* base, int levels, int stride, int n, int sigma,
    const int32_t* pattern, int max_m, int length,
    int32_t* lo_out, int32_t* hi_out) {
  int lo = 0, hi = n;
  for (int t = 0; t < max_m; ++t) {
    if (t >= length || lo >= hi) break;  // inactive from here on
    const int c = pattern[iclamp(length - 1 - t, 0, max_m - 1)];
    if (c < 0 || c >= sigma) {
      lo = hi = (c < 0) ? 0 : n;
      break;
    }
    int p = lo, q = hi;
    for (int lvl = 0; lvl < levels; ++lvl) {
      const int bit = (c >> (levels - 1 - lvl)) & 1;
      const int z = RT_LDG(zcount + lvl);
      const int r1p = wm_rank1(words, prefix, stride, lvl, p);
      const int r1q = wm_rank1(words, prefix, stride, lvl, q);
      p = bit == 0 ? p - r1p : z + r1p;
      q = bit == 0 ? q - r1q : z + r1q;
    }
    const int b = RT_LDG(base + c);
    lo = b + p;
    hi = b + q;
  }
  *lo_out = lo;
  *hi_out = imax(lo, hi);
}

// ---------------------------------------------------------------------------
// ILCP listing (replaces repro/kernels/ilcp_list.py, _ilcp_list_kernel):
// the Fig-1 recursion of repro/core/ilcp.py run directly by one query.
// ---------------------------------------------------------------------------

RT_HD int stack_cap(int max_df) { return max_df + 4; }
RT_HD int pop_cap(int max_df) { return 2 * max_df + 8; }

// Leftmost argmin of vilcp[a..b] through the sparse table (levels x rho);
// b < a answers the span-1 query at a.  Also the whole of the batched RMQ
// kernel (repro/kernels/rmq.py, _rmq_kernel).
RT_HD int rmq_leftmost(const int32_t* table, const int32_t* vilcp, int levels,
                       int rho, int a, int b) {
  const int span = imax(b - a + 1, 1);
  const int k = iclamp(31 - RT_CLZ((unsigned)span), 0, levels - 1);
  const int right = imax(b - (1 << k) + 1, a);
  const int ia = RT_LDG(table + (int64_t)k * rho + a);
  const int ib = RT_LDG(table + (int64_t)k * rho + right);
  const int va = RT_LDG(vilcp + ia);
  const int vb = RT_LDG(vilcp + ib);
  return (vb < va || (vb == va && ib < ia)) ? ib : ia;
}

// Lists the distinct documents of DA[lo, hi) in discovery order into
// docs[0:max_df] (-1 padded) and returns their count.  stka/stkb hold
// stack_cap(max_df) entries; seen holds ceil(d/32) zeroed words.  The
// trajectory is the reference's: every pop counts toward pop_cap (even an
// invalid a > b one); a seen document aborts its interval and its pushes;
// pushes go right (i_run+1, b) then left (a, i_run-1) while sp < cap.
RT_HD int ilcp_list_one(
    const int32_t* vilcp, const int32_t* table, const int32_t* run_starts,
    const int32_t* da, int levels, int rho, int n, int d, int max_df,
    int lo, int hi, int lo_run, int hi_run,
    int32_t* stka, int32_t* stkb, uint32_t* seen, int32_t* docs) {
  for (int s = 0; s < max_df; ++s) docs[s] = -1;
  const int cap = stack_cap(max_df);
  const int max_pops = pop_cap(max_df);
  stka[0] = lo_run;
  stkb[0] = hi_run;
  int sp = 1, cnt = 0, pops = 0;
  while (sp > 0 && cnt < max_df && pops < max_pops) {
    --sp;
    ++pops;
    const int a = stka[sp], b = stkb[sp];
    if (a > b || lo >= hi) continue;
    const int r = rmq_leftmost(table, vilcp, levels, rho,
                               iclamp(a, 0, rho - 1), iclamp(b, 0, rho - 1));
    int k = imax(lo, RT_LDG(run_starts + iclamp(r, 0, rho - 1)));
    const int j = imin(hi, RT_LDG(run_starts + iclamp(r + 1, 0, rho)));
    bool aborted = false;
    for (; k < j && cnt < max_df; ++k) {
      const int g = RT_LDG(da + iclamp(k, 0, n - 1));
      const int gc = iclamp(g, 0, d - 1);
      const uint32_t bit = 1u << (gc & 31);
      if (seen[gc >> 5] & bit) {
        aborted = true;
        break;
      }
      seen[gc >> 5] |= bit;
      docs[cnt++] = g;
    }
    if (aborted) continue;
    if (r + 1 <= b && sp < cap) {
      stka[sp] = r + 1;
      stkb[sp] = b;
      ++sp;
    }
    if (a <= r - 1 && sp < cap) {
      stka[sp] = a;
      stkb[sp] = r - 1;
      ++sp;
    }
  }
  return cnt;
}

}  // namespace rt

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
// Warp helpers.  In the device pass a query is served by a warp (kWarp
// lanes); in every host pass the same code runs as one lane that plays the
// warp's lanes in turn, so the host build checks the same arithmetic.
// ---------------------------------------------------------------------------

constexpr int kWarp = 32;

#ifdef __CUDA_ARCH__
RT_HD int lane_id() { return threadIdx.x & (kWarp - 1); }
RT_HD int lane_count() { return kWarp; }
RT_HD void warp_sync() { __syncwarp(); }
#else
RT_HD int lane_id() { return 0; }
RT_HD int lane_count() { return 1; }
RT_HD void warp_sync() {}
#endif

// Block helpers, for code that a whole block runs (lane = threadIdx.x of
// lanes = blockDim.x threads).  Every host pass calls such code with
// lanes == 1, one thread playing the block's threads in turn, phase by
// phase, so the barriers vanish.
#ifdef __CUDA_ARCH__
RT_HD void block_sync() { __syncthreads(); }
RT_HD bool block_all(bool x) { return __syncthreads_and(x) != 0; }
#else
RT_HD void block_sync() {}
RT_HD bool block_all(bool x) { return x; }
#endif

// *x += v, returning the old *x: atomically on the device (shared or
// global memory), in turn on the host.
RT_HD int fetch_add(int32_t* x, int v) {
#ifdef __CUDA_ARCH__
  return atomicAdd(x, v);
#else
  const int old = *x;
  *x += v;
  return old;
#endif
}

// Exclusive prefix sums of v[0, m) in place, each from `base`; returns the
// sum.  Device: the whole block, one entry per thread (m <= lanes, lanes a
// multiple of kWarp, at most 1024), by warp shuffles and one warp's pass
// over the warp sums (sums: lanes / kWarp + 1 entries); host: a loop.
RT_HD int block_exclusive_scan(int32_t* v, int m, int base, int32_t* sums,
                               int lane, int lanes) {
#ifdef __CUDA_ARCH__
  const int w = lane / kWarp, l = lane % kWarp, nw = lanes / kWarp;
  const int x = lane < m ? v[lane] : 0;
  int inc = x;
  for (int o = 1; o < kWarp; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (l >= o) inc += y;
  }
  if (l == kWarp - 1) sums[w] = inc;
  __syncthreads();
  if (w == 0) {
    const int ws = l < nw ? sums[l] : 0;
    int wi = ws;
    for (int o = 1; o < kWarp; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, wi, o);
      if (l >= o) wi += y;
    }
    if (l < nw) sums[l] = wi - ws;
    if (l == kWarp - 1) sums[nw] = wi;
  }
  __syncthreads();
  if (lane < m) v[lane] = base + sums[w] + inc - x;
  return sums[nw];
#else
  (void)sums, (void)lane, (void)lanes;
  int acc = 0;
  for (int k = 0; k < m; ++k) {
    const int x = v[k];
    v[k] = base + acc;
    acc += x;
  }
  return acc;
#endif
}

// First k in [0, len) with a[k] >= x (len when none): torch.searchsorted.
RT_HD int lower_bound(const int32_t* a, int len, int x) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (RT_LDG(a + mid) < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// First k in [0, len) with a[k] > x (len when none): right=True.
RT_HD int upper_bound(const int32_t* a, int len, int x) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (RT_LDG(a + mid) <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// ---------------------------------------------------------------------------
// Group searches: lower_bound and upper_bound run by a group of `lanes`
// lanes (a power of two, 2 to kWarp, aligned in the warp: the Sada-C
// kernel's two half-warps).  Each round the lanes probe the ends of
// `lanes` near-equal parts of the range (every position once it is no
// longer than `lanes`), one pivot a lane, and a ballot over the group
// narrows the range lanes-fold: about log_lanes(len) dependent rounds
// instead of log2(len).  A pivot costs a multiply and a shift, no
// division.  Every lane of the group calls it with the same operands and
// gets the same result.  In every host pass one lane plays the group's
// lanes in turn, so the host build checks the same arithmetic.
// ---------------------------------------------------------------------------

constexpr int kHalf = kWarp / 2;

// Pivot t of a round over [lo, lo + span): lo + t when span <= lanes,
// else the end of part t of `lanes` (t < lanes - 1); distinct and inside
// the range.
RT_HD int group_pivot(int lo, int span, int lanes, int t) {
  if (span <= lanes) return lo + t;
  return lo + (int)(((int64_t)(t + 1) * span) >> (31 - RT_CLZ((unsigned)lanes)));
}

// First k in [0, len) with a[k] >= x (kUpper: a[k] > x), len when none,
// for lane `lane` of the group.  When k < len and `at` is given, *at =
// a[k]: the round that set the range's end read it, so a caller's equality
// test costs no read of its own.
template <bool kUpper>
RT_HD int group_search(const int32_t* a, int len, int x, int lane, int lanes, int32_t* at) {
  int lo = 0, hi = len, at_hi = 0;
  while (lo < hi) {
    const int span = hi - lo, p = span <= lanes ? span : lanes - 1;
#ifdef __CUDA_ARCH__
    const unsigned mask = (lanes == kWarp ? 0xffffffffu : (1u << lanes) - 1u)
                          << (lane_id() & ~(lanes - 1));
    int v = 0;
    bool below = false;
    if (lane < p) {
      v = RT_LDG(a + group_pivot(lo, span, lanes, lane));
      below = kUpper ? v <= x : v < x;
    }
    const int c = __popc(__ballot_sync(mask, below) & mask);
    const int vc = __shfl_sync(mask, v, imin(c, p - 1), lanes);
#else
    (void)lane;
    int32_t v[kWarp];
    int c = 0;
    for (int t = 0; t < p; ++t) {
      v[t] = RT_LDG(a + group_pivot(lo, span, lanes, t));
      c += kUpper ? v[t] <= x : v[t] < x;
    }
    const int vc = v[imin(c, p - 1)];
#endif
    const int next_lo = c > 0 ? group_pivot(lo, span, lanes, c - 1) + 1 : lo;
    if (c < p) {
      hi = group_pivot(lo, span, lanes, c);
      at_hi = vc;
    }
    lo = next_lo;
  }
  if (at) *at = at_hi;
  return lo;
}

// ---------------------------------------------------------------------------
// DA sources: where a listing core reads DA[k], k clamped into [0, n).  A
// stored document array (DaStored: Sada-I-D, Sada-C-D), or a locate through
// the CSA (DaLocate, after the CSA locate below: Sada-I-L, Sada-C-L).
// ---------------------------------------------------------------------------

// kBesideValues: whether the Sada-C kernel reads DA at both of an RMQ's
// candidates beside their values (a stored read is cheaper than a
// dependent round); a source that says no has group(k, lane, lanes), DA[k]
// by a group of lanes (see group_search) resolving one position together.
struct DaStored {
  const int32_t* da;
  int n;
  static constexpr bool kBesideValues = true;
  RT_HD int operator()(int k) const { return RT_LDG(da + iclamp(k, 0, n - 1)); }
};

// ---------------------------------------------------------------------------
// ILCP listing (replaces repro/kernels/ilcp_list.py, _ilcp_list_kernel):
// the Fig-1 recursion of repro/core/ilcp.py run by one warp per query.
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

// The argmin the recursion would compute on popping (a, b): the interval
// clamped into [0, rho).
RT_HD int interval_argmin(const int32_t* table, const int32_t* vilcp,
                          int levels, int rho, int a, int b) {
  return rmq_leftmost(table, vilcp, levels, rho, iclamp(a, 0, rho - 1),
                      iclamp(b, 0, rho - 1));
}

// Run containing ILCP position pos (pos < 0 gives -1): runs_of.
RT_HD int run_of(const int32_t* run_starts, int rho, int pos) {
  return upper_bound(run_starts, rho, pos) - 1;
}

// One chunk of the scan of a run's DA positions [k, j): the kWarp positions
// from k, at most `room` of them emitted.  It emits the leading positions up
// to the first whose document is already seen or repeats an earlier
// position of the chunk, at docs_at[0..E), marks them seen, and returns E;
// *stopped says the scan met such a position while room was left: the
// recursion's abort.  Device: one position per lane, the seen test in
// shared memory, repeats by __match_any_sync, the first stop by a ballot.
// `src` gives DA[k] (a DaStored, or a DaLocate, whose lanes then locate
// their positions side by side).
template <class Src>
RT_HD int ilcp_scan_chunk(const Src& src, int d, int k, int j, int room,
                          uint32_t* seen, int32_t* docs_at, bool* stopped) {
  const int nvalid = imin(j - k, kWarp);
#ifdef __CUDA_ARCH__
  const int lane = lane_id();
  const bool valid = lane < nvalid;
  const int g = valid ? src(k + lane) : 0;
  const int gc = iclamp(g, 0, d - 1);
  const bool was = valid && ((seen[gc >> 5] >> (gc & 31)) & 1u);
  const unsigned peers = __match_any_sync(0xffffffffu, valid ? gc : -1 - lane);
  const bool dup = valid && (peers & ((1u << lane) - 1u)) != 0u;
  const unsigned stop = __ballot_sync(0xffffffffu, was || dup);
  const int first = stop ? __ffs(stop) - 1 : kWarp;
  const int emit = imin(imin(first, nvalid), room);
  __syncwarp();  // every lane has read the bitmap before any lane marks it
  if (lane < emit) {
    docs_at[lane] = g;
    atomicOr(seen + (gc >> 5), 1u << (gc & 31));
  }
  __syncwarp();
#else
  int32_t g[kWarp];
  int first = kWarp;
  for (int l = 0; l < nvalid; ++l) g[l] = src(k + l);
  for (int l = 0; l < nvalid && first == kWarp; ++l) {
    const int gc = iclamp(g[l], 0, d - 1);
    bool stop = (seen[gc >> 5] >> (gc & 31)) & 1u;
    for (int e = 0; e < l; ++e) stop = stop || iclamp(g[e], 0, d - 1) == gc;
    if (stop) first = l;
  }
  const int emit = imin(imin(first, nvalid), room);
  for (int l = 0; l < emit; ++l) {
    const int gc = iclamp(g[l], 0, d - 1);
    docs_at[l] = g[l];
    seen[gc >> 5] |= 1u << (gc & 31);
  }
#endif
  *stopped = first < nvalid && first < room;
  return emit;
}

// The stored-DA form.
RT_HD int ilcp_scan_chunk(const int32_t* da, int n, int d, int k, int j,
                          int room, uint32_t* seen, int32_t* docs_at,
                          bool* stopped) {
  return ilcp_scan_chunk(DaStored{da, n}, d, k, j, room, seen, docs_at, stopped);
}

// Lists the distinct documents of DA[lo, hi) in discovery order into
// docs[0:max_df] (-1 padded) and returns their count; every lane of the
// warp runs it with the same values.  Each stack entry (stka, stkb, stkr;
// stack_cap(max_df) entries, written by lane 0) holds an interval and its
// argmin run, resolved when the interval is pushed: lanes 0 and 1 issue the
// two children's RMQs before the run's reads, so a pop starts with its run
// in hand.  seen holds ceil(d/32) words, zeroed here.  The trajectory is the
// reference's: every pop counts toward pop_cap (even an invalid a > b one);
// a seen document aborts its interval and its pushes; pushes go right
// (r+1, b) then left (a, r-1) while sp < cap.  `src` gives DA[k]: Sada-I-D
// reads a stored DA (DaStored), Sada-I-L locates through the CSA (DaLocate).
template <class Src>
RT_HD int ilcp_list_one(
    const int32_t* vilcp, const int32_t* table, const int32_t* run_starts,
    const Src& src, int levels, int rho, int d, int max_df,
    int lo, int hi, int lo_run, int hi_run, int32_t* stka, int32_t* stkb,
    int32_t* stkr, uint32_t* seen, int32_t* docs) {
  const int lane = lane_id(), lanes = lane_count();
  const bool leader = lane == 0;
  for (int w = lane; w < (d + 31) / 32; w += lanes) seen[w] = 0u;
  const int cap = stack_cap(max_df);
  const int max_pops = pop_cap(max_df);
  const int root = (lo_run <= hi_run && lo < hi)
      ? interval_argmin(table, vilcp, levels, rho, lo_run, hi_run) : 0;
  if (leader) {
    stka[0] = lo_run;
    stkb[0] = hi_run;
    stkr[0] = root;
  }
  warp_sync();
  int sp = 1, cnt = 0, pops = 0;
  while (sp > 0 && cnt < max_df && pops < max_pops) {
    --sp;
    ++pops;
    const int a = stka[sp], b = stkb[sp], r = stkr[sp];
    if (a > b || lo >= hi) continue;
    const bool push_right = r + 1 <= b, push_left = a <= r - 1;
#ifdef __CUDA_ARCH__
    int child = 0;
    if (lane == 0 && push_right) child = interval_argmin(table, vilcp, levels, rho, r + 1, b);
    if (lane == 1 && push_left) child = interval_argmin(table, vilcp, levels, rho, a, r - 1);
#endif
    int k = imax(lo, RT_LDG(run_starts + iclamp(r, 0, rho - 1)));
    const int j = imin(hi, RT_LDG(run_starts + iclamp(r + 1, 0, rho)));
    bool stopped = false;
    while (k < j && cnt < max_df && !stopped) {
      const int e = ilcp_scan_chunk(src, d, k, j, max_df - cnt, seen, docs + cnt, &stopped);
      k += e;
      cnt += e;
    }
#ifdef __CUDA_ARCH__
    const int right = __shfl_sync(0xffffffffu, child, 0);
    const int left = __shfl_sync(0xffffffffu, child, 1);
#else
    const int right = push_right ? interval_argmin(table, vilcp, levels, rho, r + 1, b) : 0;
    const int left = push_left ? interval_argmin(table, vilcp, levels, rho, a, r - 1) : 0;
#endif
    if (stopped) continue;
    warp_sync();  // every lane has read the popped entry before lane 0 overwrites it
    if (push_right && sp < cap) {
      if (leader) {
        stka[sp] = r + 1;
        stkb[sp] = b;
        stkr[sp] = right;
      }
      ++sp;
    }
    if (push_left && sp < cap) {
      if (leader) {
        stka[sp] = a;
        stkb[sp] = r - 1;
        stkr[sp] = left;
      }
      ++sp;
    }
    warp_sync();
  }
  for (int s = cnt + lane; s < max_df; s += lanes) docs[s] = -1;
  return cnt;
}

// The stored-DA form (Sada-I-D).
RT_HD int ilcp_list_one(
    const int32_t* vilcp, const int32_t* table, const int32_t* run_starts,
    const int32_t* da, int levels, int rho, int n, int d, int max_df,
    int lo, int hi, int lo_run, int hi_run, int32_t* stka, int32_t* stkb,
    int32_t* stkr, uint32_t* seen, int32_t* docs) {
  return ilcp_list_one(vilcp, table, run_starts, DaStored{da, n}, levels, rho, d,
                       max_df, lo, hi, lo_run, hi_run, stka, stkb, stkr, seen, docs);
}

// ---------------------------------------------------------------------------
// CSA locate (the port's counterpart of repro/core/csa.py csa_lookup and
// csa_doc_of, one position at a time).
// ---------------------------------------------------------------------------

struct CsaView {
  const int32_t* words;       // [levels, stride] BWT wavelet bit patterns
  const int32_t* prefix;      // [levels, stride] ones before each word
  const int32_t* zcount;      // [levels]
  const int32_t* counts;      // [sigma + 1] symbols strictly below c
  const int32_t* sym_starts;  // [sigma]
  const int32_t* sampled;     // sorted sampled SA positions (sampled_len stored)
  const int32_t* samples;     // [sampled_m] SA values at the sampled positions
  const int32_t* doc_starts;  // sorted document starts (doc_len stored)
  int levels, stride, n, sample_rate, sampled_len, sampled_m, doc_len;
};

// LF(j) = counts[c] + rank_c(BWT, j) for c = BWT[j].  Reading c bit by bit
// descends j along c's own bits, so the access descent is also the rank
// descent: one word and one prefix read per level.
RT_HD int csa_lf(const CsaView& c, int j) {
  int pos = j, sym = 0;
  for (int lvl = 0; lvl < c.levels; ++lvl) {
    const int64_t w = (int64_t)lvl * c.stride + (pos >> 5);
    const uint32_t word = (uint32_t)RT_LDG(c.words + w);
    const int bit = (word >> (pos & 31)) & 1u;
    const int r1 = RT_LDG(c.prefix + w) + RT_POPC(word & ((1u << (pos & 31)) - 1u));
    pos = bit ? RT_LDG(c.zcount + lvl) + r1 : pos - r1;
    sym = (sym << 1) | bit;
  }
  return RT_LDG(c.counts + sym) + pos - RT_LDG(c.sym_starts + sym);
}

// SA[i]: LF steps until a sampled position, at most sample_rate of them (a
// walk needs fewer: every text position that is a multiple of sample_rate,
// and every document start, is sampled).  The same integers as the batched
// walk's sample_rate masked rounds.
RT_HD int csa_locate_one(const CsaView& c, int i) {
  int j = i, steps = 0;
  for (int s = 0; s < c.sample_rate; ++s) {
    const int k = imin(lower_bound(c.sampled, c.sampled_len, j), imax(c.sampled_m - 1, 0));
    if (c.sampled_m > 0 && RT_LDG(c.sampled + k) == j) break;
    j = csa_lf(c, j);
    ++steps;
  }
  const int r = lower_bound(c.sampled, c.sampled_len, j);
  return RT_LDG(c.samples + iclamp(r, 0, c.sampled_m - 1)) + steps;
}

// DA[i] given SA[i]: rank over the document starts.
RT_HD int csa_doc_of(const CsaView& c, int text_pos) {
  return lower_bound(c.doc_starts, c.doc_len, text_pos + 1) - 1;
}

// csa_locate_one by a group of lanes (see group_search), the same
// integers: each step's search over the sampled positions is a group
// search whose last rounds read the entry it returns, so the sampled test
// reads nothing of its own, and the step that finds j sampled gives the
// sample's rank too.  The LF descent stays serial (csa_lf, every lane of
// the group reading the same words).
RT_HD int csa_locate_group(const CsaView& c, int i, int lane, int lanes) {
  int j = i, steps = 0, r = -1;
  for (int s = 0; s < c.sample_rate; ++s) {
    int32_t at = 0;
    const int k = group_search<false>(c.sampled, c.sampled_len, j, lane, lanes, &at);
    if (k < c.sampled_m && at == j) {
      r = k;
      break;
    }
    j = csa_lf(c, j);
    ++steps;
  }
  if (r < 0) r = group_search<false>(c.sampled, c.sampled_len, j, lane, lanes, nullptr);
  return RT_LDG(c.samples + iclamp(r, 0, c.sampled_m - 1)) + steps;
}

// csa_doc_of by a group of lanes.
RT_HD int csa_doc_of_group(const CsaView& c, int text_pos, int lane, int lanes) {
  return group_search<false>(c.doc_starts, c.doc_len, text_pos + 1, lane, lanes, nullptr) - 1;
}

// DA[k] = rank_B(SA[k]): the Sadakane replacement for a stored DA.
struct DaLocate {
  CsaView c;
  static constexpr bool kBesideValues = false;
  RT_HD int operator()(int k) const {
    return csa_doc_of(c, csa_locate_one(c, iclamp(k, 0, c.n - 1)));
  }
  RT_HD int group(int k, int lane, int lanes) const {
    return csa_doc_of_group(c, csa_locate_group(c, iclamp(k, 0, c.n - 1), lane, lanes), lane,
                            lanes);
  }
};

// ---------------------------------------------------------------------------
// Sada-C listing (the port's own kernel; the reference's sada_c_list_docs in
// repro/core/listing.py is XLA): Sadakane's RMQ recursion over the C array
// with V-marking, one warp per query.
// ---------------------------------------------------------------------------

// Int32 words of one warp's shared memory: the interval stack (four per
// entry, 16-byte aligned) and the seen bitmap, rounded to 16 bytes.
RT_HD int sada_c_shared_ints(int d, int max_df) {
  return 4 * stack_cap(max_df) + ((d + 31) / 32 + 3) / 4 * 4;
}

// The leftmost argmin k of C over [a, b] clamped to hi - 1 (and into [0,
// n)), and DA[k] into *g, by lane `lane` of a group of kHalf lanes: the
// RMQ's two table reads (rmq_leftmost's), then its two value reads, then
// the source's group resolution; a stored DA (kBesideValues) is read at
// both candidates beside the values, so its resolution takes two
// dependent rounds, not three.
template <class Src>
RT_HD int sada_c_resolve(const int32_t* table, const int32_t* values, int levels, int n,
                         const Src& src, int hi, int a, int b, int lane, int* g) {
  const int x = iclamp(imin(a, hi - 1), 0, n - 1), y = iclamp(imin(b, hi - 1), 0, n - 1);
  const int lvl = iclamp(31 - RT_CLZ((unsigned)imax(y - x + 1, 1)), 0, levels - 1);
  const int ia = RT_LDG(table + (int64_t)lvl * n + x);
  const int ib = RT_LDG(table + (int64_t)lvl * n + imax(y - (1 << lvl) + 1, x));
  const int va = RT_LDG(values + ia), vb = RT_LDG(values + ib);
  if constexpr (Src::kBesideValues) {
    const int ga = src(ia), gb = src(ib);
    const bool right = vb < va || (vb == va && ib < ia);
    *g = right ? gb : ga;
    return right ? ib : ia;
  } else {
    const int k = (vb < va || (vb == va && ib < ia)) ? ib : ia;
    *g = src.group(k, lane, kHalf);
    return k;
  }
}

// Stack entry e: one 16-byte vector in the device pass.
RT_HD void sada_c_set(int32_t* stk, int e, int a, int b, int k, int g) {
#ifdef __CUDA_ARCH__
  reinterpret_cast<int4*>(stk)[e] = make_int4(a, b, k, g);
#else
  stk[4 * e] = a;
  stk[4 * e + 1] = b;
  stk[4 * e + 2] = k;
  stk[4 * e + 3] = g;
#endif
}

RT_HD void sada_c_get(const int32_t* stk, int e, int* a, int* b, int* k, int* g) {
#ifdef __CUDA_ARCH__
  const int4 v = reinterpret_cast<const int4*>(stk)[e];
  *a = v.x, *b = v.y, *k = v.z, *g = v.w;
#else
  *a = stk[4 * e], *b = stk[4 * e + 1], *k = stk[4 * e + 2], *g = stk[4 * e + 3];
#endif
}

// Lists the distinct documents of DA[lo, hi) in discovery order into
// docs[0:max_df] (-1 padded) and returns their count; every lane of the
// warp runs it with the same values.  stk holds stack_cap(max_df) entries
// (a, b, k, g): an interval, the leftmost argmin k of C over it and its
// document g = DA[k], resolved when the interval is pushed (the root
// before the loop); seen holds ceil(d/32) words, zeroed here.  The
// trajectory is the reference's: the root interval is (lo, hi - 1); every
// pop counts toward pop_cap, an invalid one (a > b, or lo >= hi) too; k is
// the argmin over the interval clamped to hi - 1 (and into [0, n), so a
// masked (0, 0) row reads nothing out of bounds: the reference's index -1
// wraps, and the row pops its one invalid interval either way); a seen
// document prunes the interval and its pushes; an unseen one is reported
// and pushes (k+1, b), then (a, k-1), while sp < cap.  So a pop reads only
// shared memory, and a reported pop resolves its children side by side:
// the right one by lanes [0, kHalf), the left by [kHalf, kWarp), each
// written by its group's lane 0 (sada_c_resolve: two dependent rounds on
// a stored DA, the RMQ's two and a group locate on the CSA).  A child that
// is not pushed, or that the loop would never pop (cnt reached max_df,
// pops reached pop_cap), is not resolved.  `src` gives DA[k]: Sada-C-D
// reads a stored DA (DaStored), Sada-C-L locates through the CSA
// (DaLocate) with group searches.
template <class Src>
RT_HD int sada_c_list_one(const int32_t* table, const int32_t* values, int levels, int n,
                          const Src& src, int d, int max_df, int lo, int hi, int32_t* stk,
                          uint32_t* seen, int32_t* docs) {
  const int lane = lane_id(), lanes = lane_count(), sub = lane % kHalf;
  for (int w = lane; w < (d + 31) / 32; w += lanes) seen[w] = 0u;
  const int cap = stack_cap(max_df), max_pops = pop_cap(max_df);
  int root = 0, root_doc = 0;
  if (lo < hi)
    root = sada_c_resolve(table, values, levels, n, src, hi, lo, hi - 1, sub, &root_doc);
  if (lane == 0) sada_c_set(stk, 0, lo, hi - 1, root, root_doc);
  warp_sync();
  int sp = 1, cnt = 0, pops = 0;
  while (sp > 0 && cnt < max_df && pops < max_pops) {
    --sp;
    ++pops;
    int a, b, k, g;
    sada_c_get(stk, sp, &a, &b, &k, &g);
    if (a > b || lo >= hi) continue;
    const int gc = iclamp(g, 0, d - 1);
    if ((seen[gc >> 5] >> (gc & 31)) & 1u) continue;
    warp_sync();  // every lane has read the entry and the bitmap before they are written
    if (lane == 0) {
      seen[gc >> 5] |= 1u << (gc & 31);
      docs[cnt] = g;
    }
    ++cnt;
    const bool more = cnt < max_df && pops < max_pops;
    const bool right = more && k + 1 <= b && sp < cap;
    const bool left = more && a <= k - 1 && sp + right < cap;
    // side 0 is the right child, side 1 the left: on the device each
    // half-warp takes its own side, in a host pass the one lane takes both
    // in turn
    for (int side = lane / kHalf; side < 2; side += imax(lanes / kHalf, 1)) {
      if (!(side == 0 ? right : left)) continue;
      const int ca = side == 0 ? k + 1 : a, cb = side == 0 ? b : k - 1;
      int cg;
      const int ck = sada_c_resolve(table, values, levels, n, src, hi, ca, cb, sub, &cg);
      if (sub == 0) sada_c_set(stk, sp + (side == 0 ? 0 : right), ca, cb, ck, cg);
    }
    sp += right + left;
    warp_sync();
  }
  for (int s = cnt + lane; s < max_df; s += lanes) docs[s] = -1;
  return cnt;
}

// ---------------------------------------------------------------------------
// WT listing (the port's own kernel; the reference's wt_list_docs in
// repro/core/wtlist.py is XLA): a left-first DFS over the wavelet matrix of
// DA, one thread per query.
// ---------------------------------------------------------------------------

// Stack entries of wt_list_one: levels + 2 for levels <= 32.
constexpr int kWtStack = 34;

// Emits the distinct documents of DA[lo, hi) in ascending order into
// docs[0:max_df] (-1 padded), each with its frequency hi' - lo' in freqs (0
// padded), and returns the count.  A node is (level, lo, hi, value prefix);
// a nonempty internal node at level l pushes its 1-child [z_l + rank1(lo),
// z_l + rank1(hi)), then its 0-child [rank0(lo), rank0(hi)), each if
// nonempty, so the 0-child (smaller ids) pops first; a nonempty leaf
// (level == levels) emits its prefix, the document.  One word and one
// prefix read per range end and level (wm_rank1).
// The stack never holds more than levels + 1 entries: after a pop at level
// l it holds at most one pending 1-child at each level 1..l and the two
// children at l + 1.  The reference's caps, max_df (levels + 1) + 4 entries
// and 4 max_df (levels + 1) + 16 pops, therefore never bind: every pop but
// an empty root's takes a nonempty node on the way down to the next leaf
// emitted, at most levels + 1 of them per leaf, so a query pops at most
// max(1, count (levels + 1)) times.  *pops and *depth (when not null)
// report the pops and the deepest stack, for the host build's test.
RT_HD int wt_list_one(const int32_t* words, const int32_t* prefix,
                      const int32_t* zcount, int levels, int stride, int lo, int hi,
                      int max_df, int32_t* docs, int32_t* freqs, int* pops_out,
                      int* depth_out) {
  int sl[kWtStack], sa[kWtStack], sb[kWtStack], sv[kWtStack];
  sl[0] = 0;
  sa[0] = lo;
  sb[0] = hi;
  sv[0] = 0;
  int sp = 1, cnt = 0, pops = 0, depth = 1;
  while (sp > 0 && cnt < max_df) {
    --sp;
    ++pops;
    const int lvl = sl[sp], a = sa[sp], b = sb[sp], val = sv[sp];
    if (a >= b) continue;
    if (lvl >= levels) {
      docs[cnt] = val;
      freqs[cnt] = b - a;
      ++cnt;
      continue;
    }
    const int r1a = wm_rank1(words, prefix, stride, lvl, a);
    const int r1b = wm_rank1(words, prefix, stride, lvl, b);
    const int z = RT_LDG(zcount + lvl);
    if (r1a < r1b && sp < kWtStack) {
      sl[sp] = lvl + 1;
      sa[sp] = z + r1a;
      sb[sp] = z + r1b;
      sv[sp] = (val << 1) | 1;
      ++sp;
    }
    if (a - r1a < b - r1b && sp < kWtStack) {
      sl[sp] = lvl + 1;
      sa[sp] = a - r1a;
      sb[sp] = b - r1b;
      sv[sp] = val << 1;
      ++sp;
    }
    depth = imax(depth, sp);
  }
  for (int s = cnt; s < max_df; ++s) {
    docs[s] = -1;
    freqs[s] = 0;
  }
  if (pops_out) *pops_out = pops;
  if (depth_out) *depth_out = depth;
  return cnt;
}

// ---------------------------------------------------------------------------
// PDL gather (the port's own kernel; the reference's _pdl_gather in
// repro/core/pdl.py is XLA): the (doc, tf) entries covering SA[lo, hi).
// ---------------------------------------------------------------------------

struct PdlView {
  const int32_t* leaf_starts;     // [L + 1]
  const uint8_t* is_first_child;  // [L + I] bool
  const int32_t* parent_of;       // [L + I]
  const int32_t* next_leaf;       // [max(I, 1)]
  const int32_t* set_off;         // [L + I + 1]
  const int32_t* A;               // [lenA]
  const int32_t* rule_left;       // [nrule]
  const int32_t* rule_right;      // [nrule]
  const int32_t* doc_base;        // [L + I + 1]
  const int32_t* freq_vals;       // [nruns]
  const int32_t* freq_gcum;       // [nruns]
  int L, I, d, lenA, nrule, nruns, block_size, iter_cap, stack_size, has_freqs;
};

// Full leaves ln..rn (rn < ln: none), the head partial block [lo, lo + wh)
// and the tail partial block [tail_lo, tail_lo + wt), each at most
// block_size positions long.
struct PdlGeometry {
  int ln, rn, lo, wh, tail_lo, wt;
};

RT_HD PdlGeometry pdl_geometry(const PdlView& p, int lo, int hi) {
  PdlGeometry g;
  g.ln = lower_bound(p.leaf_starts, p.L, lo);
  g.rn = upper_bound(p.leaf_starts + 1, p.L, hi) - 1;
  const int head_hi = imin(hi, RT_LDG(p.leaf_starts + imin(g.ln, p.L)));
  g.lo = lo;
  g.wh = iclamp(head_hi - lo, 0, p.block_size);
  g.tail_lo = imax(RT_LDG(p.leaf_starts + imin(imax(g.rn + 1, g.ln), p.L)), head_hi);
  g.wt = iclamp(hi - g.tail_lo, 0, p.block_size);
  return g;
}

// The window entries e = lane, lane + lanes, ... below min(wh + wt, cap):
// entry e is the head's position lo + e, then the tail's, each located
// through the CSA, with frequency 1.
RT_HD void pdl_windows(const CsaView& c, const PdlGeometry& g, int32_t* buf,
                       int32_t* fbuf, int cap, int lane, int lanes) {
  const int entries = imin(g.wh + g.wt, cap);
  for (int e = lane; e < entries; e += lanes) {
    const int pos = e < g.wh ? g.lo + e : g.tail_lo + (e - g.wh);
    buf[e] = csa_doc_of(c, csa_locate_one(c, imin(pos, c.n - 1)));
    fbuf[e] = 1;
  }
}

// Fig 4 parent(): the highest stored ancestor of leaf `leaf` whose subtree
// ends at leaf rn or before; *nxt is the leaf after it.
RT_HD int pdl_climb_one(const PdlView& p, int leaf, int rn, int* nxt) {
  const int top = p.L + p.I - 1;
  int node = leaf;
  *nxt = leaf + 1;
  for (;;) {
    const int nc = imin(node, top);
    const int par = RT_LDG(p.parent_of + nc);
    if (!RT_LDG(p.is_first_child + nc) || par < 0) break;
    const int nl = RT_LDG(p.next_leaf + iclamp(par, 0, imax(p.I - 1, 0)));
    if (nl - 1 > rn) break;
    node = p.L + par;
    *nxt = nl;
  }
  return node;
}

// Decompresses node nd's list into buf from base on, at most cap - base
// entries and iter_cap steps, with the grammar stack (stack_size entries,
// entry i at stack[i * stride]; a full stack overwrites its top slot while
// sp still grows, as the reference's does).  fbuf takes 1 in listing mode
// and, in top-k mode, the entry's global position doc_base[nd] + cnt,
// which pdl_freqs turns into its frequency.  Returns the new base.
RT_HD int pdl_expand_one(const PdlView& p, int nd, int32_t* buf, int32_t* fbuf,
                         int base, int cap, int32_t* stack, int stride) {
  const int ndc = iclamp(nd, 0, p.L + p.I - 1);
  int ptr = RT_LDG(p.set_off + ndc);
  const int end = RT_LDG(p.set_off + ndc + 1);
  const int gbase = RT_LDG(p.doc_base + ndc);
  const int top = p.stack_size - 1;
  int sp = 0, cnt = 0, it = 0;
  while (it < p.iter_cap && (ptr < end || sp > 0) && base + cnt < cap) {
    ++it;
    int sym;
    if (sp > 0) {
      sym = stack[imin(sp - 1, top) * stride];
      --sp;
    } else {
      sym = RT_LDG(p.A + imin(ptr, p.lenA - 1));
      ++ptr;
    }
    if (sym < p.d) {
      buf[base + cnt] = sym;
      fbuf[base + cnt] = p.has_freqs ? gbase + cnt : 1;
      ++cnt;
    } else {
      const int ridx = iclamp(sym - p.d - 1, 0, p.nrule - 1);
      const int right = RT_LDG(p.rule_right + ridx);
      const int left = RT_LDG(p.rule_left + ridx);
      stack[imin(sp, top) * stride] = right;  // left expands first
      ++sp;
      stack[imin(sp, top) * stride] = left;
      ++sp;
    }
  }
  return base + cnt;
}

// The cover loop in the reference's order: at most max_cover climbs from
// leaf ln while the next leaf is <= rn, each followed by its node's
// expansion.  Returns the count.
RT_HD int pdl_cover(const PdlView& p, int ln, int rn, int base, int cap,
                    int max_cover, int32_t* buf, int32_t* fbuf, int32_t* stack) {
  int i = ln;
  for (int it = 0; it < max_cover && i <= rn; ++it) {
    int nxt;
    const int node = pdl_climb_one(p, i, rn, &nxt);
    base = pdl_expand_one(p, node, buf, fbuf, base, cap, stack, 1);
    i = nxt;
  }
  return base;
}

// Chunks of leaves whose members are held for one expansion phase.
constexpr int kPdlRounds = 4;

// Scratch of the block-wide cover walk (shared memory on the device) for
// chunks of `chunk` leaves, with room for kPdlRounds chunks' members.
struct PdlScratch {
  int32_t* node;   // [kPdlRounds * chunk] held members' nodes; a chunk's
                   // climbs land after them
  int32_t* off;    // [kPdlRounds * chunk] their entry counts, then first slots
  int32_t* next;   // [chunk] the leaf after each climb's node
  int32_t* sums;   // [chunk / kWarp + 1] the device scan's warp sums
  int32_t* chain;  // [2] the chunk's members and the next chunk's head;
                   // [0] then the next member to expand
  int32_t* stack;  // [stack_size * chunk] thread l's entry e at e * chunk + l
};

RT_HD int pdl_scratch_ints(int chunk, int stack_size) {
  return chunk * (2 * kPdlRounds + 1 + stack_size) + chunk / kWarp + 1 + 2;
}

RT_HD PdlScratch pdl_scratch(int32_t* mem, int chunk) {
  PdlScratch s;
  s.node = mem;
  s.off = s.node + kPdlRounds * chunk;
  s.next = s.off + kPdlRounds * chunk;
  s.sums = s.next + chunk;
  s.chain = s.sums + chunk / kWarp + 1;
  s.stack = s.chain + 2;
  return s;
}

// Nodes node[0, held) expanded at slots off[0, held), side by side:
// thread `lane` expands node lane, then, each time it is done, the next
// node not yet taken (*next, which starts at lanes), so a thread with a
// long node takes no others.  `stack`: this thread's.
RT_HD void pdl_expand_members(const PdlView& p, const int32_t* node, const int32_t* off,
                              int held, int cap, int32_t* buf, int32_t* fbuf,
                              int32_t* stack, int stride, int32_t* next, int lane) {
  for (int k = lane; k < held; k = fetch_add(next, 1))
    pdl_expand_one(p, node[k], buf, fbuf, off[k], cap, stack, stride);
}

// The cover of leaves ln..rn walked by a block, `chunk` leaves at a time
// (device: chunk == lanes, one leaf per thread).  Per chunk: (1) every leaf
// from the head is climbed at once; a climb depends only on its leaf and
// rn, so a leaf on the chain climbs as the serial walk's does.  (2) The
// chain from the head picks the members, at most max_cover in all: every
// climbed leaf when every climb ends at the leaf after it (the usual case:
// one __syncthreads_and), else by following the links in shared memory.
// (3) A scan of the members' entry counts |D_v| = doc_base[v + 1] -
// doc_base[v] gives each member its first slot.  Members are held until
// kPdlRounds chunks' worth could overflow the scratch or the walk ends;
// then (4) the threads expand the held members side by side, each thread
// taking the next member when its last is done (pdl_expand_members), each
// below cap with the thread's own stack.
// The walk ends at rn, at max_cover members, or once the slots reach cap:
// past that the serial walk writes nothing and its count stays cap.  The
// slots assume that a node's expansion emits exactly |D_v| entries within
// iter_cap steps and stack_size entries, as a well-formed index's does (a
// node of m entries and |A_v| list symbols takes 2m - |A_v| steps).
// Returns pdl_cover's count: base when base >= cap, else
// min(base + entries, cap).
RT_HD int pdl_cover_block(const PdlView& p, int ln, int rn, int base, int cap,
                          int max_cover, int chunk, int32_t* buf, int32_t* fbuf,
                          const PdlScratch& s, int lane, int lanes) {
  int head = ln, members = 0, end = base, held = 0;
  for (;;) {
    if (head <= rn && members < max_cover && end < cap &&
        held + chunk <= kPdlRounds * chunk) {
      int32_t* node = s.node + held;
      int32_t* off = s.off + held;
      const int valid = imin(chunk, rn - head + 1);
      bool run = true;
      for (int k = lane; k < valid; k += lanes) {
        int nxt;
        node[k] = pdl_climb_one(p, head + k, rn, &nxt);
        s.next[k] = nxt;
        run = run && nxt == head + k + 1;
      }
      run = block_all(run);  // also the barrier before the chain reads the climbs
      if (lane == 0) {
        const int room = max_cover - members;
        int m = 0, leaf = head;
        if (run) {
          m = imin(valid, room);
          leaf = head + m;
        } else {
          while (leaf - head < valid && m < room) {  // compacts node[] in place
            node[m++] = node[leaf - head];
            leaf = s.next[leaf - head];
          }
        }
        s.chain[0] = m;
        s.chain[1] = leaf;
      }
      block_sync();
      const int m = s.chain[0];
      head = s.chain[1];
      for (int k = lane; k < m; k += lanes) {
        const int nd = iclamp(node[k], 0, p.L + p.I - 1);
        off[k] = RT_LDG(p.doc_base + nd + 1) - RT_LDG(p.doc_base + nd);
      }
      const int total = block_exclusive_scan(off, m, end, s.sums, lane, lanes);
      end += total;
      members += m;
      held += m;
      continue;
    }
    if (held == 0) break;
    if (lane == 0) s.chain[0] = lanes;  // the next member to take
    block_sync();
    pdl_expand_members(p, s.node, s.off, held, cap, buf, fbuf, s.stack + lane, chunk,
                       s.chain, lane);
    held = 0;
    block_sync();  // the next chunks overwrite node and off
  }
  return base >= cap ? base : imin(end, cap);
}

// Top-k mode: each expanded entry's global position -> its stored
// frequency, freq_vals[run of the position], for slots [from, to).
RT_HD void pdl_freqs(const PdlView& p, int32_t* fbuf, int from, int to,
                     int lane, int lanes) {
  for (int s = from + lane; s < to; s += lanes) {
    const int run = upper_bound(p.freq_gcum, p.nruns, fbuf[s]);
    fbuf[s] = RT_LDG(p.freq_vals + imin(run, p.nruns - 1));
  }
}

// Zeroes slots [from, cap) of both rows.
RT_HD void pdl_zero_tail(int32_t* buf, int32_t* fbuf, int from, int cap,
                         int lane, int lanes) {
  for (int s = from + lane; s < cap; s += lanes) {
    buf[s] = 0;
    fbuf[s] = 0;
  }
}

// One query of the gather in the reference's order, serially: head window,
// tail window, cover; rows of max_buf entries.  Returns the count, which
// exceeds max_buf when the windows overran the buffer.  The order that
// pdl_gather_block's pieces are held to.
RT_HD int pdl_gather_one(const CsaView& c, const PdlView& p, int lo, int hi,
                         int max_buf, int max_cover, int32_t* buf,
                         int32_t* fbuf, int32_t* stack) {
  const PdlGeometry g = pdl_geometry(p, lo, hi);
  const int wend = g.wh + g.wt;
  pdl_windows(c, g, buf, fbuf, max_buf, 0, 1);
  const int count = pdl_cover(p, g.ln, g.rn, wend, max_buf, max_cover, buf, fbuf, stack);
  if (p.has_freqs) pdl_freqs(p, fbuf, imin(wend, max_buf), imin(count, max_buf), 0, 1);
  pdl_zero_tail(buf, fbuf, imin(count, max_buf), max_buf, 0, 1);
  return count;
}

// One query of the gather by a block (the kernel's body): the windows'
// positions spread over every thread, then the block-wide cover, then the
// frequencies and the row's tail.  The same integers as pdl_gather_one.
RT_HD int pdl_gather_block(const CsaView& c, const PdlView& p, int lo, int hi,
                           int max_buf, int max_cover, int chunk, int32_t* buf,
                           int32_t* fbuf, const PdlScratch& s, int lane,
                           int lanes) {
  const PdlGeometry g = pdl_geometry(p, lo, hi);
  const int wend = g.wh + g.wt;
  pdl_windows(c, g, buf, fbuf, max_buf, lane, lanes);
  const int count = pdl_cover_block(p, g.ln, g.rn, wend, max_buf, max_cover, chunk,
                                    buf, fbuf, s, lane, lanes);
  const int end = imin(count, max_buf);
  if (p.has_freqs) pdl_freqs(p, fbuf, imin(wend, max_buf), end, lane, lanes);
  pdl_zero_tail(buf, fbuf, end, max_buf, lane, lanes);
  return count;
}

}  // namespace rt

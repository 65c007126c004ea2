// The embedding-bag kernel's lane-group logic, written once as
// __host__ __device__ functions: nvcc compiles them into the __global__
// kernel of model_kernels.cu, and a host C++ compiler compiles the same
// code for the core's CPU test (tests/test_torch_embedding_bag_core.py),
// where one thread plays each lane of a warp in turn.
//
// A bag is served by a group of G lanes (G a power of two, 1 to 32), each
// lane holding one W-byte vector of the row's columns, so a warp serves
// 32 / G bags side by side, each lane with U = 4 rows in flight.  The two
// kernel loops:
//   bags of one (L == 1): a warp takes a tile of U * 32 / G bags; its lanes
//     load the tile's indices once, coalesced, and each group takes its U
//     bags' indices by shuffle, starts its U row loads, then writes U rows;
//   longer bags (L != 1): each group takes one bag; its lanes load the
//     bag's index row a chunk at a time (G x P entries, P = max(1, U / G)
//     a lane) and each round takes U indices by shuffle and starts U row
//     loads before it adds the U rows, in index order.
// Every output element is an f32 sum in index order, rounded once to the
// table's type: the plain version's arithmetic, so the results match it
// bit for bit, and a bag of one returns its row (a -0.0 element as +0.0,
// as the plain version's 0 + x does).
#pragma once

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define EB_HD __host__ __device__ __forceinline__
#define EB_UNROLL _Pragma("unroll")
#else
#define EB_HD inline
#define EB_UNROLL
#endif

#ifdef __CUDACC__
#include <cuda_bf16.h>
#endif

namespace eb {

constexpr int kWarp = 32;
constexpr int kMaxVecBytes = 16;  // vectors of 16, 8, 4 or 2 bytes
constexpr int kU = 4;  // rows a lane has in flight

// Storage types of the table and the output: a tag each, so the same code
// compiles where __nv_bfloat16 does not exist.
struct F32 {
  static constexpr int kBytes = 4;
};
struct BF16 {
  static constexpr int kBytes = 2;
};

// ---------------------------------------------------------------------------
// The plan: vector width W, lanes a bag G, rows in flight a lane U
// ---------------------------------------------------------------------------

struct Plan {
  int W;       // bytes a lane loads and stores at once: 16, 8, 4 or 2
  int G;       // lanes a bag
  int U;       // rows a lane has in flight (kU)
  int R;       // row bytes, D * element bytes
  int nvec;    // vectors a row, R / W
  int chunks;  // column chunks a group walks, ceil(nvec / G)
  int lg;      // log2(G)
  int bpw;     // bags a warp serves at once, 32 / G
  int tile;    // bags of one a warp tile takes, bpw * U
  int P;       // longer bags: index registers a lane fills a chunk, max(1, U / G)
  int chunk;   // longer bags: entries of an index chunk, G * P
};

EB_HD int pow2_ceil(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

EB_HD int log2_of(int p) {
  int l = 0;
  while ((1 << l) < p) ++l;
  return l;
}

// The widest vector of 16, 8, 4 or 2 bytes (never narrower than one
// element) that divides the row's bytes and both base addresses; then
// G = min(32, next power of two >= R / W).  Computed on the host, so the
// kernel divides by nothing.
EB_HD Plan make_plan(int D, int esize, uintptr_t table, uintptr_t out) {
  Plan p{};
  p.R = D * esize;
  p.W = esize;
  for (int w = kMaxVecBytes; w >= 2; w >>= 1) {
    if (w >= esize && p.R % w == 0 && table % w == 0 && out % w == 0) {
      p.W = w;
      break;
    }
  }
  p.nvec = p.R / p.W;
  p.G = pow2_ceil(p.nvec) < kWarp ? pow2_ceil(p.nvec) : kWarp;
  p.U = kU;
  p.chunks = (p.nvec + p.G - 1) / p.G;
  p.lg = log2_of(p.G);
  p.bpw = kWarp / p.G;
  p.tile = p.bpw * p.U;
  p.P = p.U > p.G ? p.U / p.G : 1;
  p.chunk = p.G * p.P;
  return p;
}

template <int N>
struct Const {
  static constexpr int value = N;
};

// Host side: f(Const<W>()) for the plan's W, the instantiation the plan
// runs; -1 for a width the type cannot take.
template <class T, class F>
inline int with_plan(const Plan& p, F f) {
  switch (p.W) {
    case 16:
      return f(Const<16>());
    case 8:
      return f(Const<8>());
    case 4:
      return f(Const<4>());
  }
  if constexpr (T::kBytes == 2) {
    if (p.W == 2) return f(Const<2>());
  }
  return -1;
}

// Work items the warps of the grid stride over (host side): tiles of bags
// of one, or the bpw bags a warp's groups take at once of longer bags.
inline long long warp_items(const Plan& p, long long B, int L) {
  const long long per = L == 1 ? p.tile : p.bpw;
  return (B + per - 1) / per;
}

// ---------------------------------------------------------------------------
// Element conversions (bf16 by its bit pattern on the host)
// ---------------------------------------------------------------------------

EB_HD float f32_of_bits(uint32_t u) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  float f;
  memcpy(&f, &u, 4);
  return f;
#endif
}

EB_HD uint32_t bits_of_f32(float f) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(f);
#else
  uint32_t u;
  memcpy(&u, &f, 4);
  return u;
#endif
}

EB_HD float bf16_to_f32(uint32_t h) {
#ifdef __CUDA_ARCH__
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)h));
#else
  return f32_of_bits(h << 16);
#endif
}

// f32 to bf16 bits, round to nearest even (NaN to the quiet NaN 0x7fc0 on
// the host; the device's conversion gives its own NaN pattern).
EB_HD uint32_t bf16_bits_rn(float x) {
#ifdef __CUDA_ARCH__
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
#else
  const uint32_t u = bits_of_f32(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0u;
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
#endif
}

// ---------------------------------------------------------------------------
// W-byte vectors: loads from the read-only table, stores to the output
// ---------------------------------------------------------------------------

template <int W>
struct Vec {
  uint32_t w[W / 4];
};
template <>
struct Vec<2> {
  uint32_t w[1];  // the low 16 bits
};

template <int W>
EB_HD Vec<W> vec_zero() {
  Vec<W> v;
  EB_UNROLL
  for (int i = 0; i < (W >= 4 ? W / 4 : 1); ++i) v.w[i] = 0u;
  return v;
}

template <int W>
EB_HD Vec<W> load_vec(const uint8_t* p) {
  Vec<W> v;
#ifdef __CUDA_ARCH__
  if constexpr (W == 16) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    v.w[0] = x.x, v.w[1] = x.y, v.w[2] = x.z, v.w[3] = x.w;
  } else if constexpr (W == 8) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    v.w[0] = x.x, v.w[1] = x.y;
  } else if constexpr (W == 4) {
    v.w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else {
    v.w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
#else
  v.w[0] = 0u;
  memcpy(v.w, p, W);
#endif
  return v;
}

// Output stores are streaming (st.global.cs, evict first): the output is
// written once and should not push the table's hot rows out of L2.
template <int W>
EB_HD void store_vec(uint8_t* p, const Vec<W>& v) {
#ifdef __CUDA_ARCH__
  if constexpr (W == 16) {
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]));
  } else if constexpr (W == 8) {
    __stcs(reinterpret_cast<uint2*>(p), make_uint2(v.w[0], v.w[1]));
  } else if constexpr (W == 4) {
    __stcs(reinterpret_cast<unsigned int*>(p), v.w[0]);
  } else {
    __stcs(reinterpret_cast<unsigned short*>(p), (unsigned short)v.w[0]);
  }
#else
  memcpy(p, v.w, W);
#endif
}

// Elements a vector holds, element e as f32, and a vector of rounded sums.
template <class T, int W>
EB_HD constexpr int elems() {
  return W / T::kBytes;
}

template <class T, int W>
EB_HD float elem(const Vec<W>& v, int e) {
  if constexpr (T::kBytes == 4) {
    return f32_of_bits(v.w[e]);
  } else {
    return bf16_to_f32((v.w[e >> 1] >> ((e & 1) * 16)) & 0xffffu);
  }
}

template <class T, int W>
EB_HD Vec<W> rounded(const float (&acc)[elems<T, W>()]) {
  Vec<W> v = vec_zero<W>();
  EB_UNROLL
  for (int e = 0; e < elems<T, W>(); ++e) {
    if constexpr (T::kBytes == 4) {
      v.w[e] = bits_of_f32(acc[e]);
    } else {
      v.w[e >> 1] |= bf16_bits_rn(acc[e]) << ((e & 1) * 16);
    }
  }
  return v;
}

// The in-order accumulate: one row's vector added to the running sums.
template <class T, int W>
EB_HD void accumulate(float (&acc)[elems<T, W>()], const Vec<W>& v) {
  EB_UNROLL
  for (int e = 0; e < elems<T, W>(); ++e) acc[e] += elem<T, W>(v, e);
}

// A bag's sums (count rows) for mean or sum, rounded and stored at out.
template <class T, int W>
EB_HD void finish(uint8_t* out, float (&acc)[elems<T, W>()], int count, int mean) {
  if (mean) {
    const float denom = (float)(count > 1 ? count : 1);
    EB_UNROLL
    for (int e = 0; e < elems<T, W>(); ++e) acc[e] = acc[e] / denom;
  }
  store_vec<W>(out, rounded<T, W>(acc));
}

// Register r of a, r uniform across the warp (a select chain, so the array
// stays in registers).
template <int U>
EB_HD int32_t pick(const int32_t (&a)[U], int r) {
  int32_t x = a[0];
  EB_UNROLL
  for (int k = 1; k < U; ++k) x = k == r ? a[k] : x;
  return x;
}

// ---------------------------------------------------------------------------
// Bags of one (L == 1): one warp tile of p.tile bags from `base`
// ---------------------------------------------------------------------------

// Phase 1, every lane: indices base + 32 r + lane, r < ceil(tile / 32),
// in one coalesced load each (-1 past B and in unused registers).
template <int U>
EB_HD void bag1_load_indices(const Plan& p, const int32_t* idx, long long B, long long base,
                             int lane, int32_t (&ir)[U]) {
  const int regs = (p.tile + kWarp - 1) >> 5;
  EB_UNROLL
  for (int r = 0; r < U; ++r) {
    const long long i = base + (long long)r * kWarp + lane;
#ifdef __CUDA_ARCH__
    ir[r] = r < regs && i < B ? __ldg(idx + i) : -1;
#else
    ir[r] = r < regs && i < B ? idx[i] : -1;
#endif
  }
}

// Phase 2, every lane: its group's U bags (bag u of group s is tile
// position u * 32 / G + s), each index taken by shfl(value, reg, src lane),
// the U row loads of each column chunk started, then the U rows written.
// `shfl` gets this lane's register `reg` and returns that register of lane
// `src` (all lanes call it alike: __shfl_sync on the device).
template <class T, int W, int U, class Shfl>
EB_HD void bag1_tile(const Plan& p, const uint8_t* table, uint8_t* out, long long B,
                     long long base, int mean, int lane, const int32_t (&ir)[U], Shfl shfl) {
  const int bpw = p.bpw;
  const int g = lane & (p.G - 1), s = lane >> p.lg;
  int32_t row[U];
  EB_UNROLL
  for (int u = 0; u < U; ++u) {
    const int pos = u * bpw + s;  // (u * bpw) >> 5 is the same on every lane
    const int reg = (u * bpw) >> 5;
    row[u] = shfl(pick<U>(ir, reg), reg, pos & (kWarp - 1));
  }
  for (int c = 0; c < p.chunks; ++c) {
    const int col = c * p.G + g;
    const bool on = col < p.nvec;
    Vec<W> v[U];
    EB_UNROLL
    for (int u = 0; u < U; ++u) {
      const long long bag = base + u * bpw + s;
      v[u] = on && bag < B && row[u] >= 0
                 ? load_vec<W>(table + (long long)row[u] * p.R + (long long)col * W)
                 : vec_zero<W>();
    }
    EB_UNROLL
    for (int u = 0; u < U; ++u) {
      const long long bag = base + u * bpw + s;
      if (!on || bag >= B) continue;
      float acc[elems<T, W>()];
      EB_UNROLL
      for (int e = 0; e < elems<T, W>(); ++e) acc[e] = 0.f;
      accumulate<T, W>(acc, v[u]);
      finish<T, W>(out + bag * p.R + (long long)col * W, acc, row[u] >= 0 ? 1 : 0, mean);
    }
  }
}

// ---------------------------------------------------------------------------
// Longer bags (L != 1): one bag a group, its index row a chunk at a time
// ---------------------------------------------------------------------------

// Phase 1, every lane: entries t0 + G r + g of its group's bag, r < P (-1
// past L, for a bag past B and in unused registers).
template <int U>
EB_HD void rows_load_indices(const Plan& p, const int32_t* idx, int L, long long bag, bool live,
                             int t0, int lane, int32_t (&ir)[U]) {
  const int g = lane & (p.G - 1);
  EB_UNROLL
  for (int r = 0; r < U; ++r) {
    const int t = t0 + r * p.G + g;
    const bool in = live && r < p.P && t < L;
#ifdef __CUDA_ARCH__
    ir[r] = in ? __ldg(idx + bag * L + t) : -1;
#else
    ir[r] = in ? idx[bag * L + t] : -1;
#endif
  }
}

// Phase 2, every lane: the chunk's entries in rounds of U, each round's U
// indices taken by shuffle from the group's lanes (entry k of the chunk is
// register k >> lg of group lane k & (G - 1)), its U row loads started, then
// its valid rows added in index order.
template <class T, int W, int U, class Shfl>
EB_HD void rows_chunk(const Plan& p, const uint8_t* table, int col, bool on, int lane,
                      const int32_t (&ir)[U], float (&acc)[elems<T, W>()], int& count,
                      Shfl shfl) {
  const int len = p.chunk, group0 = lane & ~(p.G - 1);
  for (int k0 = 0; k0 < len; k0 += U) {
    int32_t row[U];
    Vec<W> v[U];
    EB_UNROLL
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u, reg = k >> p.lg;
      row[u] = shfl(pick<U>(ir, reg), reg, group0 | (k & (p.G - 1)));
      v[u] = on && row[u] >= 0 ? load_vec<W>(table + (long long)row[u] * p.R + (long long)col * W)
                               : vec_zero<W>();
    }
    EB_UNROLL
    for (int u = 0; u < U; ++u) {
      if (row[u] < 0) continue;
      accumulate<T, W>(acc, v[u]);
      ++count;
    }
  }
}

}  // namespace eb

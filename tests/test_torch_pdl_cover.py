"""The PDL gather kernel's block-wide cover walk, played on the host.

``rt::pdl_gather_block`` of ``repro_torch/csrc/retrieval_core.cuh`` (the
kernel's body: windows spread over the threads, then per chunk of leaves
the speculative climbs, the chain, the scan of the members' list sizes and
the members' expansions side by side) is built with g++ behind a C shim
(``test_torch_kernel_core.compile_core``), one thread playing the block's
threads in turn.  On the two seeded collections of
``test_torch_pdl_gather.py``, with both PDLs (listing and top-k), at
(max_buf, max_cover) = (4096, 1024), (64, 1024), (4096, 4), (64, 4) and a
buffer of 3 that the windows overrun, and with chunks of 1, 8 and 256
leaves, it must give the buffer, frequencies and count of the port's
``pdl_gather_plain`` and the reference's ``_pdl_gather``.  A host replay
of the chunked chain shows the cases the chunks must meet: covers longer
than a chunk, climbs that take steps, and a chain that jumps past its
chunk.

The slots of the parallel expansion assume that every node's expansion
emits exactly its list size ``doc_base[v + 1] - doc_base[v]`` within
``iter_cap`` steps and ``stack_size`` stack entries; that is checked for
every node of both PDLs, through the core's own expansion.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import csa as jcsa
from repro.core import pdl as jpdl
from repro.core.suffix import build_suffix_data as jbuild_suffix_data
from repro.core.suffix import sa_range_for_pattern
from repro.data import collections as jcoll
from repro_torch.core.csa import build_csa
from repro_torch.core.pdl import build_pdl
from repro_torch.core.suffix import Collection, build_suffix_data
from repro_torch.kernels.pdl_gather import iter_cap, pdl_gather_plain, stack_size
from test_torch_kernel_core import compile_core
from test_torch_pdl_gather import BETA, BLOCK, SHIM, SPECS, _Operands, _p


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BLOCK_SHIM = SHIM + r"""
extern "C" void core_pdl_gather_block(const void* const* p, const int* v,
                                      const int32_t* lo, const int32_t* hi,
                                      int32_t* buf, int32_t* fbuf,
                                      int32_t* count, int B, int max_buf,
                                      int max_cover, int chunk) {
  const rt::CsaView c = csa_view(p, v);
  const rt::PdlView pd = pdl_view(p, v);
  std::vector<int32_t> mem(rt::pdl_scratch_ints(chunk, pd.stack_size));
  const rt::PdlScratch s = rt::pdl_scratch(mem.data(), chunk);
  for (int q = 0; q < B; ++q)
    count[q] = rt::pdl_gather_block(c, pd, lo[q], hi[q], max_buf, max_cover,
                                    chunk, buf + (long)q * max_buf,
                                    fbuf + (long)q * max_buf, s, 0, 1);
}

// Every node's expansion alone, into rows of `width` slots (cap = width),
// its stack interleaved with `stride` - 1 others: the entries it emits.
extern "C" void core_pdl_expand_nodes(const void* const* p, const int* v,
                                      int32_t* buf, int32_t* fbuf,
                                      int32_t* emitted, int width,
                                      int stride) {
  const rt::PdlView pd = pdl_view(p, v);
  std::vector<int32_t> stack((long)pd.stack_size * stride, -1);
  for (int nd = 0; nd < pd.L + pd.I; ++nd)
    emitted[nd] = rt::pdl_expand_one(pd, nd, buf + (long)nd * width,
                                     fbuf + (long)nd * width, 0, width,
                                     stack.data() + stride - 1, stride);
}
"""

#: (max_buf, max_cover): no truncation; the expansion cut by the buffer;
#: the cover cut; both; a buffer the windows overrun
CONFIGS = {"full": (4096, 1024), "max_buf": (64, 1024), "cover4": (4096, 4),
           "both": (64, 4), "windows": (3, 1024)}
CHUNKS = (1, 8, 256)


@pytest.fixture(scope="module")
def core(tmp_path_factory):
    return compile_core(BLOCK_SHIM, tmp_path_factory.mktemp("pdl_cover_core"))


@pytest.fixture(scope="module", params=list(SPECS))
def indexes(request):
    coll = jcoll.generate(SPECS[request.param])
    jdata = jbuild_suffix_data(coll)
    tcoll = Collection(text=coll.text, doc_starts=coll.doc_starts,
                       doc_ends=coll.doc_ends, d=coll.d, sigma=coll.sigma)
    tdata = build_suffix_data(tcoll, "cpu")
    tc = build_csa(tdata)
    modes = {}
    for mode, beta in (("list", BETA), ("topk", None)):
        jp = jpdl.build_pdl(jdata, block_size=BLOCK, beta=beta, mode=mode)
        tp = build_pdl(tdata, block_size=BLOCK, beta=beta, mode=mode)
        modes[mode] = (jp, tp, _Operands(tp, tc))
    ranges = [sa_range_for_pattern(jdata, p)
              for p in jcoll.random_substring_patterns(coll, 400, 3, 40, seed=11)]
    n = coll.n
    ranges += [(0, 0), (9, 3), (3, BLOCK - 1), (0, n), (1, n - 1), (n // 3, n - BLOCK - 1),
               (BLOCK + 1, n - 2)]
    return {"jcsa": jcsa.build_csa(jdata), "tcsa": tc, "modes": modes,
            "lo": np.asarray([r[0] for r in ranges], np.int32),
            "hi": np.asarray([r[1] for r in ranges], np.int32), "want": {}, "ref_fn": {}}


def _want(indexes, mode, config):
    """(plain, reference) outputs of one PDL and config, computed once; the
    reference is compiled once per PDL and max_buf, max_cover traced."""
    if (mode, config) not in indexes["want"]:
        jp, tp, _ = indexes["modes"][mode]
        lo, hi = indexes["lo"], indexes["hi"]
        max_buf, max_cover = CONFIGS[config]
        plain = [x.numpy() for x in pdl_gather_plain(
            tp, indexes["tcsa"], torch.from_numpy(lo), torch.from_numpy(hi), max_buf, max_cover)]
        key = (mode, max_buf)
        if key not in indexes["ref_fn"]:
            jc = indexes["jcsa"]
            indexes["ref_fn"][key] = jax.jit(jax.vmap(
                lambda a, b, c: jpdl._pdl_gather(jp, jc, a, b, max_buf, c), (0, 0, None)))
        ref = indexes["ref_fn"][key](jnp.asarray(lo), jnp.asarray(hi), jnp.int32(max_cover))
        indexes["want"][mode, config] = (plain, [np.asarray(x) for x in ref])
    return indexes["want"][mode, config]


def _host(tp):
    return {f: getattr(tp, f).numpy() for f in
            ("leaf_starts", "is_first_child", "parent_of", "next_leaf", "doc_base", "set_off",
             "A", "rule_left", "rule_right")}


def _climb(h, L, leaf, rn):
    """Fig 4 parent() of one leaf: (node, next leaf, climb steps)."""
    node, nxt, steps = leaf, leaf + 1, 0
    while h["is_first_child"][node] and h["parent_of"][node] >= 0:
        par = int(h["parent_of"][node])
        if h["next_leaf"][par] - 1 > rn:
            break
        node, nxt, steps = L + par, int(h["next_leaf"][par]), steps + 1
    return node, nxt, steps


def _chunked_chain(h, L, lo, hi, max_cover, chunk):
    """Host replay of the kernel's chunked chain for SA[lo, hi): (members,
    chunks, the members' climb steps, chunks the chain left past their
    last leaf)."""
    ls = h["leaf_starts"]
    ln = int(np.searchsorted(ls[:L], lo, "left"))
    rn = int(np.searchsorted(ls[1:], hi, "right")) - 1
    head, members, chunks, steps, jumps = ln, 0, 0, 0, 0
    while head <= rn and members < max_cover:
        valid = min(chunk, rn - head + 1)
        climbs = [_climb(h, L, leaf, rn) for leaf in range(head, head + valid)]
        leaf = head
        while leaf - head < valid and members < max_cover:
            _, nxt, st = climbs[leaf - head]
            members, steps, leaf = members + 1, steps + st, nxt
        jumps += leaf > head + valid
        chunks += 1
        head = leaf
    return members, chunks, steps, jumps


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("mode", ["list", "topk"])
def test_block_gather_three_ways(core, indexes, mode, config, chunk):
    """The block-wide gather, one thread playing the block, equals the plain
    version and the reference's ``_pdl_gather``: buffer, tf and count."""
    max_buf, max_cover = CONFIGS[config]
    _, _, ops = indexes["modes"][mode]
    lo, hi = indexes["lo"], indexes["hi"]
    B = lo.shape[0]
    buf = np.full((B, max_buf), -7, np.int32)
    fbuf = np.full((B, max_buf), -7, np.int32)
    count = np.zeros(B, np.int32)
    core.core_pdl_gather_block(ops.ptrs, ops.ints, _p(lo), _p(hi), _p(buf), _p(fbuf),
                               _p(count), B, max_buf, max_cover, chunk)
    plain, ref = _want(indexes, mode, config)
    for name, got, p, r in zip(("docs", "tf", "count"), (buf, fbuf, count), plain, ref):
        np.testing.assert_array_equal(p, r, err_msg=f"plain {name} != reference")
        np.testing.assert_array_equal(got, r, err_msg=f"block core {name} != reference")
    # the config's truncation occurs
    if config == "windows":
        assert (count > max_buf).any()
    if config == "max_buf":
        assert (count == max_buf).any()


@pytest.mark.parametrize("mode", ["list", "topk"])
def test_chunked_chain_cases(indexes, mode):
    """With chunks of 8 leaves the test's ranges meet covers of several
    chunks, climbs that take steps, and chains that leave a chunk past its
    last leaf (a climb's node spans the chunk's end); max_cover 4 cuts
    covers short."""
    _, tp, _ = indexes["modes"][mode]
    h = _host(tp)
    stats = [_chunked_chain(h, tp.L, a, b, 1024, 8)
             for a, b in zip(indexes["lo"].tolist(), indexes["hi"].tolist())]
    assert max(s[1] for s in stats) > 1
    assert sum(s[2] for s in stats) > 0
    assert sum(s[3] for s in stats) > 0
    assert max(s[0] for s in stats) > 4


def _expand_all(h, d, nd):
    """The uncapped expansion of node nd: (entries, steps, deepest stack)."""
    out, steps, deepest = [], 0, 0
    stack = []
    ptr, end = int(h["set_off"][nd]), int(h["set_off"][nd + 1])
    while ptr < end or stack:
        steps += 1
        if stack:
            sym = stack.pop()
        else:
            sym, ptr = int(h["A"][ptr]), ptr + 1
        if sym < d:
            out.append(sym)
        else:
            r = sym - d - 1
            stack += [int(h["rule_right"][r]), int(h["rule_left"][r])]
            deepest = max(deepest, len(stack))
    return out, steps, deepest


@pytest.mark.parametrize("mode", ["list", "topk"])
def test_every_node_expands_to_its_list_size(core, indexes, mode):
    """The invariant the kernel's slots rest on: each node v's expansion
    emits exactly doc_base[v + 1] - doc_base[v] entries, in 2m - |A_v|
    steps (<= iter_cap) with at most stack_size stack entries; the core's
    expansion, its stack interleaved with others, emits the same entries
    (and, in top-k mode, their global positions)."""
    _, tp, ops = indexes["modes"][mode]
    h = _host(tp)
    N = tp.L + tp.I
    width = iter_cap(tp)
    buf = np.zeros((N, width), np.int32)
    fbuf = np.zeros((N, width), np.int32)
    emitted = np.zeros(N, np.int32)
    core.core_pdl_expand_nodes(ops.ptrs, ops.ints, _p(buf), _p(fbuf), _p(emitted), width, 3)
    sizes = np.diff(h["doc_base"])
    for nd in range(N):
        entries, steps, deepest = _expand_all(h, tp.d, nd)
        m = int(sizes[nd])
        listed = int(h["set_off"][nd + 1] - h["set_off"][nd])
        assert len(entries) == m == emitted[nd], nd
        assert steps == 2 * m - listed <= iter_cap(tp), nd
        assert deepest <= stack_size(tp), nd
        assert buf[nd, :m].tolist() == entries, nd
        want_f = np.arange(h["doc_base"][nd], h["doc_base"][nd] + m) if tp.has_freqs else 1
        np.testing.assert_array_equal(fbuf[nd, :m], want_f)
    assert sizes.max() > 1 and (np.diff(h["set_off"]) < sizes).any()  # rules were expanded

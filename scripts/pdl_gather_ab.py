"""Time the PDL gather kernel against other builds of it on one card, at
the main path's shape, and check them against the plain version.

    python3 scripts/pdl_gather_ab.py [--other DIR ...] [--variants NAME ...]
                                     [--pdl list|topk]

Builds the retrieval service of ``chip_smoke.py``'s phase 2 (``--pdl
list``: dna-p001 at scale 3.2, listing PDL, ``block_size`` 64, beta 16) or
phase 2b (``--pdl topk``: scale 1.6, the top-k PDL) on the card, plans its
first batch of 32 patterns, prints the cover of the query with the longest
node expansion (host replay, ``chip_smoke.pdl_walk_ns``), and runs this
tree's gather at
``max_buf`` 4,096 and 64 and ``max_cover`` 1,024 and 4 against
``pdl_gather_plain``, bit for bit.  Beside it, each build of
``retrieval_kernels.cu`` compiled by its own ``nvcc`` into its own library
(``rt_pdl_gather`` keeps its C interface) and called with the same
operands: ``--other`` takes another checkout's sources, ``--variants``
this tree's with the text edits ``VARIANTS`` lists.  A build's mismatches
against this tree's outputs are counted (a ``diagnostic`` variant differs
on purpose; one that measures writes its measurement into each row's
count, which is printed), and all are timed in turns (builds, this tree,
this tree, builds reversed) by CUDA events around calls queued behind a
spin kernel.  Prints ptxas's registers of each ``pdl_gather_kernel``, the
card's name and power limit, and one JSON line of results last.  Needs one
card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

from ab_build import build_library, ptxas_line, variant_sources  # noqa: E402
from chip_smoke import (  # noqa: E402
    MAX_BUF, nvidia_smi_line, pdl_host_arrays, pdl_walk_ns, queued_time_ms, require,
)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import pdl_gather as pg  # noqa: E402

CONFIGS = ((MAX_BUF, 1024), (64, 1024), (MAX_BUF, 4), (64, 4))
CORE, KERNELS = "retrieval_core.cuh", "retrieval_kernels.cu"
LAUNCHERS = ("rt_pdl_gather",)
EXPAND_CALL = ("    pdl_expand_members(p, s.node, s.off, held, cap, buf, fbuf, s.stack + lane, "
               "chunk,\n                       s.chain, lane);")

#: name -> (edits (file, old text, new text; the old text occurs once),
#: diagnostic)
VARIANTS = {
    # members dealt round robin (thread l: members l, l + 256, ...) instead
    # of taken from the shared counter
    "static_members": (((CORE, "k < held; k = fetch_add(next, 1))", "k < held; k += 256)"),),
                       False),
    # the launch bound without a minimum of blocks per SM
    "launch_bounds_256": (((KERNELS, "__launch_bounds__(kGatherThreads, 1)",
                            "__launch_bounds__(kGatherThreads)"),), False),
    # the rules copied into shared memory at the block's start, and read there
    "rules_in_shared": (
        ((CORE, "      const int right = RT_LDG(p.rule_right + ridx);\n"
                "      const int left = RT_LDG(p.rule_left + ridx);",
          "      const int right = p.rule_right[ridx];\n      const int left = p.rule_left[ridx];"),
         (KERNELS, "  const int q = blockIdx.x;\n  const int c = rt::pdl_gather_block(\n"
                   "      csa, pdl,",
          "  const int q = blockIdx.x;\n  rt::PdlView pv = pdl;\n"
          "  int32_t* rl = smem + rt::pdl_scratch_ints(kGatherThreads, pdl.stack_size);\n"
          "  for (int i = threadIdx.x; i < pdl.nrule; i += kGatherThreads) {\n"
          "    rl[i] = pdl.rule_left[i];\n    rl[pdl.nrule + i] = pdl.rule_right[i];\n  }\n"
          "  __syncthreads();\n  pv.rule_left = rl;\n  pv.rule_right = rl + pdl.nrule;\n"
          "  const int c = rt::pdl_gather_block(\n      csa, pv,"),
         (KERNELS, "(size_t)rt::pdl_scratch_ints(kGatherThreads, stack_size);",
          "((size_t)rt::pdl_scratch_ints(kGatherThreads, stack_size) + 2 * (size_t)nrule);")),
        False),
    # diagnostic: the expansions write nothing (buffer and frequencies)
    "no_stores": (((CORE, "      buf[base + cnt] = sym;\n"
                          "      fbuf[base + cnt] = p.has_freqs ? gbase + cnt : 1;\n", ""),), True),
    # diagnostic: no member is expanded
    "no_expansion": (((CORE, EXPAND_CALL, "    (void)buf, (void)fbuf;"),), True),
    # diagnostic: each row's count is the most clock cycles a thread of its
    # block spent in the member expansions
    "expansion_cycles": (
        ((CORE, "  int head = ln, members = 0, end = base, held = 0;\n",
          "  int head = ln, members = 0, end = base, held = 0;\n  long long cycles = 0;\n"),
         (CORE, EXPAND_CALL,
          "    const long long t0 = clock64();\n" + EXPAND_CALL + "\n"
          "    cycles += clock64() - t0;"),
         (CORE, "  return base >= cap ? base : imin(end, cap);\n}",
          "  __syncthreads();\n  if (lane == 0) s.chain[0] = 0;\n  __syncthreads();\n"
          "  atomicMax(&s.chain[0], (int)cycles);\n  __syncthreads();\n  return s.chain[0];\n}"),
         (CORE, "#pragma once\n", "#pragma once\n#ifndef __CUDA_ARCH__\n#define clock64() 0LL\n"
                "#define __syncthreads()\n#define atomicMax(a, b) 0\n#endif\n")),
        True),
}


def gather_with(lib, index, csa, lo, hi, max_buf, max_cover):
    """The wrapper's launch through another library: (docs, tf, count)."""
    tensors, ints = pg.kernel_operands(index, csa)
    B, dev = lo.shape[0], lo.device
    docs = torch.empty((B, max_buf), dtype=torch.int32, device=dev)
    tf = torch.empty_like(docs)
    count = torch.empty(B, dtype=torch.int32, device=dev)
    _build.check(lib.rt_pdl_gather(
        *(t.data_ptr() for _, t, _ in tensors), lo.data_ptr(), hi.data_ptr(), docs.data_ptr(),
        tf.data_ptr(), count.data_ptr(), *ints, B, max_buf, max_cover,
        torch.cuda.current_stream(dev).cuda_stream), "rt_pdl_gather")
    return docs, tf, count


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", nargs="*", default=[], help="checkouts whose kernel to time beside")
    ap.add_argument("--variants", nargs="*", default=[], choices=list(VARIANTS))
    ap.add_argument("--pdl", choices=("list", "topk"), default="list")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("pdl_gather_ab: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.core.suffix import build_suffix_data
    from repro_torch.data.collections import (
        generate, paperlike_collections, random_substring_patterns,
    )
    from repro_torch.serve.retrieval import RetrievalService

    smi = nvidia_smi_line()
    print(f"[ab] {smi}", flush=True)
    dev = torch.device("cuda", 0)
    _build.library()
    print(ptxas_line("this", _build.build_log.get("ptxas", {}), "pdl_gather"), flush=True)
    topk = args.pdl == "topk"
    coll = generate(paperlike_collections(scale=1.6 if topk else 3.2)["dna-p001"])
    svc = RetrievalService.build(coll, block_size=64, beta=16.0, topk_index=topk, device=dev)
    pats = random_substring_patterns(coll, 2000, 6, 128, data=build_suffix_data(coll, dev))
    plan = svc.plan(pats[:32])
    lo = torch.from_numpy(plan["lo"]).to(dev)
    hi = torch.from_numpy(plan["hi"]).to(dev)
    index, csa = (svc.pdl_topk if topk else svc.pdl_list), svc.csa
    result = {"device": smi, "pdl": args.pdl, "n": coll.n, "L": index.L, "I": index.I,
              "B": int(lo.shape[0])}
    hp, ones = pdl_host_arrays(index), {"l1_ns": 1.0, "l2_ns": 1.0}
    doc_starts = csa.doc_bv.pos.cpu().numpy()
    covers = [pdl_walk_ns(hp, csa, doc_starts, a, b, MAX_BUF, 1024, ones, pg.GATHER_THREADS,
                          pg.PDL_ROUNDS)[1]
              for a, b in zip(plan["lo"].tolist(), plan["hi"].tolist())]
    result["longest_cover"] = max((c["cover"] for c in covers),
                                  key=lambda c: c["max_member_steps"])
    with tempfile.TemporaryDirectory() as tmp:
        builds = {d: build_library(os.path.join(d, "src", "repro_torch", "csrc"), tmp,
                                   f"other{i}", LAUNCHERS, "pdl_gather")
                  for i, d in enumerate(args.other)}
        builds.update({v: build_library(variant_sources(v, VARIANTS[v][0], tmp), tmp, v,
                                        LAUNCHERS, "pdl_gather") for v in args.variants})
        diagnostic = {name: VARIANTS[name][1] if name in VARIANTS else False for name in builds}
        mism = 0
        for max_buf, max_cover in CONFIGS:
            k = pg.pdl_gather(index, csa, lo, hi, max_buf, max_cover)
            p = pg.pdl_gather_plain(index, csa, lo, hi, max_buf, max_cover)
            mism += sum(int((x != y).sum()) for x, y in zip(k, p))
            for name, lib in builds.items():
                o = gather_with(lib, index, csa, lo, hi, max_buf, max_cover)
                result.setdefault(f"{name}_mismatches", 0)
                result[f"{name}_mismatches"] += sum(int((x != y).sum()) for x, y in zip(k, o))
                if diagnostic[name] and (max_buf, max_cover) == CONFIGS[0]:
                    result[f"{name}_counts"] = o[2].tolist()
        result["mismatches"] = mism
        print(f"[ab] mismatches against the plain version: {mism}", flush=True)
        require(mism == 0, ("pdl_gather mismatches", mism))
        for name in builds:
            require(diagnostic[name] or result[f"{name}_mismatches"] == 0,
                    (name, "differs from this tree's kernel"))
        fns = {name: (lambda lib=lib: gather_with(lib, index, csa, lo, hi, MAX_BUF, 1024))
               for name, lib in builds.items()}
        fns["this"] = lambda: pg.pdl_gather(index, csa, lo, hi, MAX_BUF, 1024)
        names = list(fns)
        for name in names + names[::-1]:
            result.setdefault(f"{name}_device_ms", []).append(queued_time_ms(fns[name], 20))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

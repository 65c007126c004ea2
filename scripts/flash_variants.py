"""Build the Hopper flash-attention kernel and textual variants of it side by
side on one card, check each against the plain version, and time them in
turns at the LM path's two shapes.

    python3 scripts/flash_variants.py [--variants kernel mask_1e30 ...]
                                      [--inputs layer0 random] [--out DIR]

Each variant is ``src/repro_torch/csrc/flash_hopper.cu`` with the text edits
``VARIANTS`` lists, compiled by its own ``nvcc`` into its own library and
called with the wrapper's arguments.  A variant is checked in a process of its own
(a kernel that hangs costs only that process's time limit); ``diagnostic``
variants compute something else on purpose and are timed, not held to the
plain version.  Times: CUDA events around calls queued behind a spin kernel,
each variant timed twice, in the order v1 .. vn vn .. v1, per input set.
``--inputs layer0`` takes llama3.2-3b's layer-0 q/k/v of seeded weights and
tokens (phase 5 of ``chip_smoke.py``), ``random`` seeded N(0, 0.25) q/k/v.
The SASS opcode counts of each variant's head-dim-128 kernel come from
``cuobjdump``.  Prints one JSON line of results last.  Needs one card.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import dataclasses
import json
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fam  # noqa: E402

SOURCE = os.path.join(ROOT, "src", "repro_torch", "csrc", "flash_hopper.cu")
BF16_ULPS = 2
SHAPES = ((4, 2048, 30), (1, 32768, 3))   # B, S, timed calls; 24/8 heads of 128

#: name -> (edits of the kernel's text, diagnostic); each edit's old text
#: occurs in the kernel exactly once
VARIANTS = {
    "kernel": ((), False),
    # the masked score written at its two uses as a constant the compiler
    # folds, -1e30 (the Pallas kernel's mask value) or -INFINITY
    "mask_1e30": ((("      float mx[2] = {masked_score(), masked_score()};",
                    "      float mx[2] = {kMask, kMask};"),
                   ("x = masked_score();", "x = kMask;")), False),
    "mask_infinity": ((("      float mx[2] = {masked_score(), masked_score()};",
                        "      float mx[2] = {-INFINITY, -INFINITY};"),
                       ("x = masked_score();", "x = -INFINITY;"),
                       ("#include <stdint.h>", "#include <math.h>\n#include <stdint.h>")), False),
    # the library's exp2f in place of ex2.approx
    "exp2f": ((('  float y;\n  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));\n'
                '  return y;', "  return exp2f(x);"),), False),
    # diagnostics: P V with P_hi alone; no softmax (P = S / 1000)
    "no_split": ((("        wgmma_rs(acc, p_lo + 4 * kk, dv);\n", ""),), True),
    "no_softmax": ((("      const bool masked = kv0 + kKeys > S_kv ||",
                     "#pragma unroll\n      for (int i = 0; i < 64; ++i) sc[i] *= 0.001f;\n"
                     "      if (kv0 < 0) {\n      const bool masked = kv0 + kKeys > S_kv ||"),
                    ("      // split P into bf16 hi + lo", "      }\n      // split P into bf16 hi + lo")),
                   True),
}


def log(*a):
    print(*a, flush=True)


def variant_source(name: str) -> str:
    text = open(SOURCE).read()
    for old, new in VARIANTS[name][0]:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} is not in the kernel once")
        text = text.replace(old, new)
    return text


def build(names, out):
    os.makedirs(out, exist_ok=True)
    nvcc, procs = _build._nvcc(), {}
    for name in names:
        src = os.path.join(out, f"flash_{name}.cu")
        with open(src, "w") as f:
            f.write(variant_source(name))
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", os.path.join(out, f"lib_{name}.so"), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    report = {}
    for name, p in procs.items():
        output = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{output}")
        ptx = _build.ptxas_report(output)
        report[name] = {"ptxas": {k: v for k, v in ptx.items() if "flash_hopper" in k},
                        "ptxas_warnings": ptx["warnings"], "sass": sass_counts(name, out)}
        log(f"[build] {name}: {report[name]}")
    return report


def sass_counts(name, out):
    """Opcode counts of the head-dim-128 instance."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", os.path.join(out, f"lib_{name}.so")],
                          capture_output=True, text=True, check=True).stdout
    for func in re.split(r"\n\s*Function : ", text):
        if "flash_hopper_kernelILi128" in func.split("\n", 1)[0]:
            ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", func)
            counts = collections.Counter(o.split(".")[0] for o in ops)
            return {"instructions": len(ops), **{k: counts[k] for k in
                                                 ("BRA", "BSSY", "ISETP", "FSEL", "FMNMX", "MUFU",
                                                  "FFMA", "HGMMA")}}
    return None


def library(name, out):
    lib = ctypes.CDLL(os.path.join(out, f"lib_{name}.so"))
    lib.rt_flash_hopper.argtypes = _build.SIGNATURES["rt_flash_hopper"]
    lib.rt_flash_hopper.restype = ctypes.c_int
    return lib


def launch(lib, q, k, v, causal=True):
    """The wrapper's call of ``rt_flash_hopper`` on this library."""
    out = torch.empty_like(q)
    B, H, S_q, Dh = q.shape
    err = lib.rt_flash_hopper(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, k.shape[1], S_q,
        k.shape[2], Dh, int(causal), *fam._tma_strides(q), *fam._tma_strides(k),
        *fam._tma_strides(v), *out.stride()[:3], torch.cuda.current_stream().cuda_stream)
    _build.check(err, "rt_flash_hopper")
    return out


def bf16_ulps(got, want) -> float:
    """``chip_smoke.bf16_ulps``."""
    g, w = got.float(), want.float()
    mag = torch.clamp(w.abs(), min=max(float(w.abs().max()) * 2**-8, 1e-30))
    return float(((g - w).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max())


def check(name, out) -> float:
    """Largest bf16 ulps from the plain version over edge shapes and the
    4 x 2,048 shape."""
    lib, dev = library(name, out), torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    for (B, H, H_kv, S_q, S_kv, Dh, causal) in (
            (2, 4, 2, 128, 128, 16, True), (1, 9, 3, 200, 200, 64, True),
            (2, 4, 4, 77, 333, 128, True), (1, 2, 2, 100, 300, 128, False),
            (1, 6, 2, 129, 129, 128, False), (1, 3, 1, 1, 70, 64, True),
            (4, 24, 8, 2048, 2048, 128, True)):
        q, k, v = (torch.randn(B, h, s, Dh, generator=gen, device=dev).mul_(0.5).bfloat16()
                   for h, s in ((H, S_q), (H_kv, S_kv), (H_kv, S_kv)))
        got = launch(lib, q, k, v, causal)
        worst = max(worst, bf16_ulps(got, fam.flash_attention_plain(q, k, v, causal=causal)))
    return worst


def queued_ms(fn, reps):
    """``chip_smoke.queued_time_ms``."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def inputs(kind, B, S, dev):
    """[B, H, S, Dh] views of [B, S, H, Dh] q, k, v, as the model passes them."""
    if kind == "random":
        gen = torch.Generator(device=dev).manual_seed(1)
        qkv = [torch.randn(B, S, h, 128, generator=gen, device=dev).mul_(0.5).bfloat16()
               for h in (24, 8, 8)]
    else:
        from repro_torch.configs import llama3_2_3b
        from repro_torch.models.transformer import _group_params, _qkv, init_params

        cfg = dataclasses.replace(llama3_2_3b.config(), attention_impl="flash")
        gen = torch.Generator(device=dev).manual_seed(0)
        params = init_params(cfg, gen, dev)
        tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
        x = params["embed"][tokens].to(cfg.act_dtype)
        qkv = _qkv(cfg, 0, _group_params(params["blocks"]["pos0"], 0), x,
                   torch.arange(S, device=dev)[None, :])
    return [t.transpose(1, 2) for t in qkv]


def time_all(names, kinds, out):
    import torch.nn.functional as F

    libs, dev, rows = {n: library(n, out) for n in names}, torch.device("cuda"), []
    for kind in kinds:
        for B, S, reps in SHAPES:
            q, k, v = inputs(kind, B, S, dev)
            flops = 2 * B * 24 * S * S * 128
            times = collections.defaultdict(list)
            for n in names + names[::-1]:
                times[n].append(queued_ms(lambda n=n: launch(libs[n], q, k, v), reps))
            sdpa = queued_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), reps)
            for n in names:
                rows.append(dict(inputs=kind, B=B, S=S, variant=n, ms=times[n],
                                 tflops=flops / min(times[n]) / 1e9, sdpa_ms=sdpa))
                log(f"[time] {kind} B={B} S={S} {n}: " + " ".join(f"{t:.4f}" for t in times[n])
                    + f" ms ({rows[-1]['tflops']:.1f} TFLOP/s); SDPA {sdpa:.4f} ms")
            del q, k, v
            torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=list(VARIANTS))
    ap.add_argument("--inputs", nargs="+", default=["layer0"], choices=["layer0", "random"])
    ap.add_argument("--out", default=str(_build.BUILD_DIR / "flash_variants"),
                    help="build directory of the variants (default: beside the kernels' build)")
    ap.add_argument("--check", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_variants: CUDA is not available; this script runs on the GPU",
              file=sys.stderr)
        return 2
    if args.check:
        print(json.dumps({"ulps": check(args.check, args.out)}), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(f"[device] {smi}")
    report = build(args.variants, args.out)
    for n in args.variants:
        proc = subprocess.run([sys.executable, __file__, "--check", n, "--out", args.out],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode:
            raise RuntimeError(f"check of {n} failed:\n{proc.stdout}{proc.stderr}")
        ulps = json.loads(proc.stdout.strip().splitlines()[-1])["ulps"]
        report[n]["max_bf16_ulps"] = ulps
        log(f"[check] {n}: {ulps:.2f} bf16 ulps from the plain version")
        if not VARIANTS[n][1] and ulps > BF16_ULPS:
            raise RuntimeError(f"{n}: {ulps} bf16 ulps from the plain version")
    rows = time_all(args.variants, args.inputs, args.out)
    print(json.dumps({"device": smi, "variants": report, "times": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

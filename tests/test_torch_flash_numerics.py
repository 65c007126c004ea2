"""The arithmetic of the Hopper flash kernel (``csrc/flash_hopper.cu``),
emulated on the CPU, against the port's plain version and the reference's
oracle; the rule that routes operands to it (``flash_route``); and the
host-side tools around it (the ptxas report of the build, the variants of
``scripts/flash_variants.py``).

The kernel itself runs only on the card (``chip_smoke.py`` holds it against
the plain version there).  What can be pinned here is why its design is
right: 128-key tiles, an f32 online softmax in the log2 domain with the
scale applied to the f32 scores after the product (the max taken over the
raw scores, then scaled; masked scores -inf, the max starting at the
Pallas kernel's -1e30), and
the probabilities split as P_hi = bf16(P), P_lo = bf16(P - P_hi) for two
bf16 products accumulated in f32.  That stays within 2 bf16 ulps of the f32
reference (``chip_smoke.BF16_ULPS``, counted by ``chip_smoke.bf16_ulps``'s
rule, copied below); rounding P to bf16 alone does not, which is why the
kernel pays for a second PV product.
"""

import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (
    flash_attention, flash_attention_plain, flash_route,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BF16_ULPS = 2       # chip_smoke.py's bf16 tolerance for the kernel
KEYS = 128          # keys per tile in the kernel
LOG2E = 1.4426950408889634
MASK = -1e30        # the Pallas kernel's mask value: the kernel's first row max

# B, H, H_kv, S_q, S_kv, Dh, causal
CASES = [
    (1, 6, 2, 1024, 1024, 128, True),    # llama3.2-3b's GQA 24/8 ratio, Dh 128
    (1, 3, 1, 1024, 1024, 64, True),     # smollm-135m's Dh 64, GQA 3/1
    (2, 4, 2, 333, 1000, 128, True),     # ragged S_kv > S_q window
    (1, 4, 4, 512, 512, 64, False),      # full attention
    (1, 2, 2, 200, 200, 128, False),     # ragged full attention
]
IDS = [f"B{b}-H{h}x{hk}-S{sq}x{skv}-D{d}-{'causal' if c else 'full'}"
       for b, h, hk, sq, skv, d, c in CASES]


def bf16_ulps(got, want) -> float:
    """Largest |got - want| in bf16 ulps at each element's magnitude, the
    magnitude floored at 2^-8 of ``want``'s largest (``chip_smoke.bf16_ulps``)."""
    g, w = got.float(), want.float()
    if w.numel() == 0:
        return 0.0
    mag = torch.clamp(w.abs(), min=max(float(w.abs().max()) * 2**-8, 1e-30))
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((g - w).abs() / ulp).max())


def emulate_kernel(q, k, v, causal, split_p=True):
    """The kernel's arithmetic on bf16 CPU tensors q [B, H, S_q, Dh], k, v
    [B, H_kv, S_kv, Dh]: per tile of ``KEYS`` keys, S = q k^T in f32,
    masked to -inf; running max m (from -1e30) of S times the f32 scale
    Dh^-0.5 * log2 e,
    sum l from the f32 p = exp2(S * scale - m), O rescaled by
    exp2(m_old - m_new); then O += bf16(P) V (+ bf16(P - bf16(P)) V with
    ``split_p``) in f32; the output O / max(l, 1e-30) rounded once to bf16.
    Tiles wholly above the diagonal, which the kernel never loads, add
    exactly nothing here."""
    B, H, S_q, Dh = q.shape
    H_kv, S_kv = k.shape[1], k.shape[2]
    rep = H // H_kv
    qf = q.float()
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    scale_log2 = torch.tensor(LOG2E / math.sqrt(Dh), dtype=torch.float32)
    m = torch.full((B, H, S_q), MASK)
    l = torch.zeros(B, H, S_q)
    acc = torch.zeros(B, H, S_q, Dh)
    rows = torch.arange(S_q)[:, None] + (S_kv - S_q)
    for kv0 in range(0, S_kv, KEYS):
        kv1 = min(kv0 + KEYS, S_kv)
        s = qf @ kf[:, :, kv0:kv1].transpose(-1, -2)
        if causal:
            s = s.masked_fill(torch.arange(kv0, kv1)[None, :] > rows, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1) * scale_log2)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * scale_log2 - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None]
        p_hi = p.bfloat16().float()
        acc = acc + p_hi @ vf[:, :, kv0:kv1]
        if split_p:
            acc = acc + (p - p_hi).bfloat16().float() @ vf[:, :, kv0:kv1]
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).bfloat16()


def _inputs(case):
    B, H, H_kv, S_q, S_kv, Dh, causal = case
    rng = np.random.default_rng(S_q * 131 + S_kv * 7 + Dh)

    def bf16(*shape):
        return torch.from_numpy((rng.standard_normal(shape) * 0.5).astype(np.float32)).bfloat16()

    return bf16(B, H, S_q, Dh), bf16(B, H_kv, S_kv, Dh), bf16(B, H_kv, S_kv, Dh), causal


def _reference(q, k, v, causal):
    """``repro.kernels.ref.flash_attention_ref`` on the same bf16 numbers,
    with the KV heads repeated as the reference's GQA does."""
    rep = q.shape[1] // k.shape[1]
    j = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)]
    out = ref.flash_attention_ref(j[0], jnp.repeat(j[1], rep, axis=1),
                                  jnp.repeat(j[2], rep, axis=1), causal=causal)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_p_within_two_ulps_of_plain_and_reference(case):
    q, k, v, causal = _inputs(case)
    got = emulate_kernel(q, k, v, causal)
    assert got.shape == q.shape and bool(torch.isfinite(got.float()).all())
    assert bf16_ulps(got, flash_attention_plain(q, k, v, causal=causal)) <= BF16_ULPS
    assert bf16_ulps(got, _reference(q, k, v, causal)) <= BF16_ULPS


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bf16_p_alone_exceeds_two_ulps(case):
    """Rounding P to bf16 once, as kernels that skip the split do, moves the
    output by far more than 2 ulps on the same inputs: the reason for the
    kernel's second PV product."""
    q, k, v, causal = _inputs(case)
    got = emulate_kernel(q, k, v, causal, split_p=False)
    assert bf16_ulps(got, flash_attention_plain(q, k, v, causal=causal)) > BF16_ULPS


def test_emulation_skips_nothing_a_tile_skip_would_change():
    """Tiles wholly above the diagonal add exactly zero: emulating only the
    keys a 128-row query block may see gives the same bits."""
    q, k, v, _ = _inputs(CASES[0])
    full = emulate_kernel(q, k, v, True)
    first = emulate_kernel(q[:, :, :KEYS], k[:, :, :KEYS], v[:, :, :KEYS], True)
    assert torch.equal(full[:, :, :KEYS], first)


# ---------------------------------------------------------------------------
# flash_route: which kernel takes which operands on the card
# ---------------------------------------------------------------------------


def _bshd(B, S, H, Dh, dtype):
    """A [B, S, H, Dh] activation seen as [B, H, S, Dh], as the model hands it."""
    return torch.zeros(B, S, H, Dh, dtype=dtype).transpose(1, 2)


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "hopper"), (torch.float32, "simt")])
def test_route_contiguous_and_transposed_views(dtype, want):
    q, kv = torch.zeros(2, 24, 256, 128, dtype=dtype), torch.zeros(2, 8, 256, 128, dtype=dtype)
    assert flash_route(q, kv, kv) == want
    q, kv = _bshd(2, 256, 24, 128, dtype), _bshd(2, 256, 8, 128, dtype)
    assert not q.is_contiguous()
    assert flash_route(q, kv, kv) == want
    q, kv = torch.zeros(1, 9, 200, 64, dtype=dtype), torch.zeros(1, 3, 333, 64, dtype=dtype)
    assert flash_route(q, kv, kv) == want


def test_route_misaligned_views_go_to_simt():
    base = torch.zeros(1, 4, 64, 136, dtype=torch.bfloat16)
    shifted = base[..., 1:129]        # base address 2 bytes past a 16-byte boundary
    assert shifted.stride(-1) == 1 and shifted.data_ptr() % 16 == 2
    assert flash_route(shifted, shifted, shifted) == "simt"
    aligned = base[..., 8:136]        # 16 bytes in: TMA takes it
    assert flash_route(aligned, aligned, aligned) == "hopper"
    odd_rows = torch.zeros(1, 4, 64, 100, dtype=torch.bfloat16)   # rows of 200 bytes
    assert flash_route(odd_rows, odd_rows, odd_rows) == "simt"
    ok = torch.zeros(1, 4, 64, 128, dtype=torch.bfloat16)
    assert flash_route(ok, shifted, ok) == "simt"     # one operand decides


def test_route_edge_operands():
    bf = torch.bfloat16
    # a dimension of size 1 has no stride to check
    one = torch.zeros(1, 1, 1, 72, dtype=bf)[..., :64]
    assert one.stride(2) == 72 and flash_route(one, one, one) == "hopper"
    # mixed dtypes, wide heads, empty KV and a non-contiguous last dimension
    q = torch.zeros(1, 2, 8, 64, dtype=bf)
    assert flash_route(q, q.float(), q.float()) == "simt"
    wide = torch.zeros(1, 2, 8, 136, dtype=bf)
    assert flash_route(wide, wide, wide) == "simt"
    empty = torch.zeros(1, 2, 0, 64, dtype=bf)
    assert flash_route(q, empty, empty) == "simt"
    strided_d = torch.zeros(1, 2, 8, 128, dtype=bf)[..., ::2]
    assert flash_route(strided_d, strided_d, strided_d) == "simt"


def test_route_option_on_cpu_runs_the_plain_version():
    q = torch.randn(1, 2, 40, 16, generator=torch.Generator().manual_seed(0)).bfloat16()
    want = flash_attention_plain(q, q, q)
    before = (flash_attention.launches, flash_attention.hopper_launches)
    for route in (None, "hopper", "simt"):
        assert torch.equal(flash_attention(q, q, q, route=route), want)
    assert (flash_attention.launches, flash_attention.hopper_launches) == before
    with pytest.raises(ValueError, match="route"):
        flash_attention(q, q, q, route="cublas")


# ---------------------------------------------------------------------------
# host-side tools: the build's ptxas report, the kernel's variants
# ---------------------------------------------------------------------------

PTXAS = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119flash_hopper_kernelILi128EEEvv' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119flash_hopper_kernelILi128EEEvv
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 584 bytes cmem[0]
ptxas warning : (C7508) setmaxnreg ignored; unable to determine register count at entry
ptxas info    : Compiling entry function '_Z4rankv' for 'sm_90a'
ptxas info    : Function properties for _Z4rankv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 16 registers, 368 bytes cmem[0]
"""


def test_ptxas_report_reads_registers_spills_and_warnings():
    report = _build.ptxas_report(PTXAS)
    assert report["_ZN12_GLOBAL__N_119flash_hopper_kernelILi128EEEvv"] == {
        "stack": 0, "spill_stores": 8, "spill_loads": 4, "registers": 168}
    assert report["_Z4rankv"]["registers"] == 16
    assert report["warnings"] == [PTXAS.splitlines()[4]]
    assert _build.ptxas_report("") == {"warnings": []}


def test_flash_variants_apply_to_the_kernel():
    """Each variant of ``scripts/flash_variants.py`` is the committed
    kernel with its edits, each edited text found exactly once."""
    path = Path(__file__).resolve().parents[1] / "scripts" / "flash_variants.py"
    spec = importlib.util.spec_from_file_location("flash_variants", path)
    fv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fv)
    kernel = Path(fv.SOURCE).read_text()
    assert fv.variant_source("kernel") == kernel
    for name, (edits, _) in fv.VARIANTS.items():
        text = fv.variant_source(name)
        assert (text != kernel) == bool(edits), name
        assert all(new in text for _, new in edits), name

"""The port stands alone: no JAX, nothing of ``repro``, no silent CPU.

* no module of ``src/repro_torch`` (nor ``chip_smoke.py``, nor the card
  scripts of ``scripts/``) imports ``jax``, ``jaxlib`` or ``repro``;
* every ``repro_torch`` module imports in a process where ``jax`` and
  ``repro`` cannot be imported;
* the entry points default to the card and raise where CUDA is missing;
* ``chip_smoke.py`` fails, and prints no result, without a card or
  without the rest of the repository.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the suite's parallel workers would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _sources():
    return (sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "scripts").glob("*.py")))


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_every_module_imports_without_jax():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from repro_torch.common import resolve_device
    from repro_torch.core.suffix import build_suffix_data, concat_documents
    from repro_torch.serve.retrieval import RetrievalService

    coll = concat_documents(["abcab", "bca"])
    with pytest.raises(RuntimeError, match="CUDA"):
        RetrievalService.build(coll)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_suffix_data(coll)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    svc = RetrievalService.build(coll, device="cpu")
    assert svc.device.type == "cpu" and svc.da.dtype == torch.int32
    assert svc.count(["ab", "ca"]).tolist() == [1, 2]
    assert svc.list_docs(["ab", "ca"]) == [[0], [0, 1]]
    assert np.asarray(svc.plan(["zz"])["occ"]).tolist() == [0]

    from repro_torch.configs import llama3_2_3b
    from repro_torch.models.transformer import init_cache, init_params

    cfg = llama3_2_3b.reduced_config()
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        init_cache(cfg, 1, 8)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert params["embed"].device.type == "cpu" and params["embed"].shape == (512, 64)
    cache = init_cache(cfg, 1, 8, device="cpu")
    assert cache["pos0"]["k"].shape == (4, 1, 8, 2, 16) and not cache["pos0"]["v"].any()


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    # alone in a directory, without the repository around it
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout

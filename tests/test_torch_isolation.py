"""The port stands alone: importing every module of p2p_llm_chat_tpu_torch
loads neither ``jax`` nor the reference package, needs no ``nvcc``, and
builds no kernel; on CPU tensors the kernel wrappers take their plain
versions and launch nothing; chip_smoke.py imports nothing of JAX and
refuses to run without a card.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import torch

from p2p_llm_chat_tpu_torch.models.configs import get_config
from p2p_llm_chat_tpu_torch.ops import paged_kv
from p2p_llm_chat_tpu_torch.ops.paged_attention import (
    paged_attention_append, paged_attention_append_reference)
from p2p_llm_chat_tpu_torch.ops.quant_mm import (quant_matmul,
                                                 quant_matmul_reference)

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "p2p_llm_chat_tpu_torch"

_IMPORT_ALL = """
import importlib, json, pkgutil, shutil, sys
import p2p_llm_chat_tpu_torch as pkg
names = sorted(m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                     pkg.__name__ + ".")
               if not m.name.endswith("__main__"))
for n in names:
    importlib.import_module(n)
from p2p_llm_chat_tpu_torch.ops import _build
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "p2p_llm_chat_tpu" or m.startswith("p2p_llm_chat_tpu."))
print(json.dumps({"modules": names, "bad": bad,
                  "nvcc": shutil.which("nvcc"),
                  "built": sorted(_build._libs)}))
"""


def test_every_module_imports_without_jax_or_nvcc():
    env = dict(os.environ)
    env["PATH"] = os.pathsep.join(
        p for p in env.get("PATH", "").split(os.pathsep)
        if not os.path.exists(os.path.join(p, "nvcc")))
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         cwd=str(ROOT), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    assert got["nvcc"] is None and got["built"] == []
    expected = {"p2p_llm_chat_tpu_torch.models.llama",
                "p2p_llm_chat_tpu_torch.ops.quant_mm",
                "p2p_llm_chat_tpu_torch.ops.paged_attention",
                "p2p_llm_chat_tpu_torch.serve.api",
                "p2p_llm_chat_tpu_torch.serve.scheduler"}
    assert expected <= set(got["modules"])


def _imports(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            names.add(node.module)
    return names


def test_no_source_of_the_port_or_chip_smoke_imports_jax():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "p2p_llm_chat_tpu"), (f, name)


def test_kernel_sources_exist_for_every_kernel():
    from p2p_llm_chat_tpu_torch.ops import _build
    for name in _build.KERNELS:
        src = _build.CSRC_DIR / f"{name}.cu"
        assert src.exists()
        assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
        # Each C entry point reports cudaGetLastError() to the wrapper.
        assert "cudaGetLastError" in src.read_text()


def test_wrappers_take_plain_path_on_cpu_and_count_nothing():
    rng = np.random.default_rng(0)
    quant_matmul.launches = 0
    paged_attention_append.launches = 0
    q = torch.from_numpy(rng.integers(-127, 128, size=(64, 32),
                                      dtype=np.int8))
    s = torch.from_numpy(rng.random((1, 32), dtype=np.float32))
    x = torch.from_numpy(rng.normal(size=(3, 64)).astype(np.float32))
    assert torch.equal(quant_matmul(x, q, s), quant_matmul_reference(x, q, s))

    cfg = get_config("tiny")
    cache = paged_kv.PagedKVCache.create(cfg, 2, 5, 8, max_pages_per_row=2,
                                         dtype=torch.float32, quantized=True,
                                         device="cpu")
    ck = torch.from_numpy(rng.normal(size=(2, 2, 16, 2, 32)).astype(
        np.float32))
    paged_kv.write_prefill_batch(cache, ck, ck * 0.5, torch.arange(2),
                                 torch.tensor([5, 16]),
                                 torch.tensor([[1, 2], [3, 4]]))
    qq = torch.from_numpy(rng.normal(size=(2, 4, 32)).astype(np.float32))
    kc = torch.from_numpy(rng.normal(size=(2, 2, 32)).astype(np.float32))
    got = paged_attention_append(qq, kc, kc, cache, cache.lengths, 1,
                                 pages=2)
    want = paged_attention_append_reference(qq, kc, kc, cache,
                                            cache.lengths, 1, pages=2)
    assert torch.equal(got, want)
    assert quant_matmul.launches == 0
    assert paged_attention_append.launches == 0


def test_chip_smoke_refuses_to_run_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")     # hide any card
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=str(ROOT), env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout

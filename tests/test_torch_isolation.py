"""The port stands alone: importing every module of p2p_llm_chat_tpu_torch
loads neither ``jax``, ``ml_dtypes`` nor the reference package, nor the
host packages the port does without (``safetensors``,
``transformers``, ``tokenizers``), needs no ``nvcc``, and
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
    paged_attention, paged_attention_append, paged_attention_append_reference,
    paged_attention_plain)
from p2p_llm_chat_tpu_torch.ops.prefill_attention import (
    prefill_attention, prefill_attention_reference)
from p2p_llm_chat_tpu_torch.ops import quant_mm
from p2p_llm_chat_tpu_torch.ops.quant_mm import (quant_matmul,
                                                 quant_matmul_reference)
from p2p_llm_chat_tpu_torch.tools.mm_micro import (w8a8_matmul,
                                                   w8a8_matmul_reference)

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
             if m in ("jax", "ml_dtypes", "safetensors", "transformers",
                      "tokenizers")
             or m.startswith(("jax.", "jaxlib", "ml_dtypes.",
                              "safetensors.", "transformers.",
                              "tokenizers."))
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
    # The walk covers the whole package (a fixed list would miss new
    # modules): every .py file under it is among the imported modules.
    files = {".".join(f.relative_to(ROOT).with_suffix("").parts)
             for f in PKG.rglob("*.py") if f.name != "__main__.py"}
    files = {n[:-len(".__init__")] if n.endswith(".__init__") else n
             for n in files} - {"p2p_llm_chat_tpu_torch"}
    assert files == set(got["modules"])
    expected = {"p2p_llm_chat_tpu_torch.models.llama",
                "p2p_llm_chat_tpu_torch.models.mixtral",
                "p2p_llm_chat_tpu_torch.models.generate",
                "p2p_llm_chat_tpu_torch.ops.dense_attention",
                "p2p_llm_chat_tpu_torch.serve.draft_model",
                "p2p_llm_chat_tpu_torch.ops.quant_mm",
                "p2p_llm_chat_tpu_torch.ops.paged_attention",
                "p2p_llm_chat_tpu_torch.ops.prefill_attention",
                "p2p_llm_chat_tpu_torch.serve.api",
                "p2p_llm_chat_tpu_torch.serve.prefix",
                "p2p_llm_chat_tpu_torch.serve.scheduler",
                "p2p_llm_chat_tpu_torch.serve.kv_tier",
                "p2p_llm_chat_tpu_torch.serve.disagg",
                "p2p_llm_chat_tpu_torch.serve.multi",
                "p2p_llm_chat_tpu_torch.models.weights",
                "p2p_llm_chat_tpu_torch.models.safetensors_io",
                "p2p_llm_chat_tpu_torch.tokenizer",
                "p2p_llm_chat_tpu_torch.utils.native",
                "p2p_llm_chat_tpu_torch.tools",
                "p2p_llm_chat_tpu_torch.tools.mm_micro",
                # The torch-free robustness plane: the port's own copies.
                "p2p_llm_chat_tpu_torch.obs",
                "p2p_llm_chat_tpu_torch.obs.trace",
                "p2p_llm_chat_tpu_torch.obs.flight",
                "p2p_llm_chat_tpu_torch.utils.failpoints",
                "p2p_llm_chat_tpu_torch.utils.backoff",
                # The chat plane: host code, the reference's wire.
                "p2p_llm_chat_tpu_torch.proto",
                "p2p_llm_chat_tpu_torch.inbox",
                "p2p_llm_chat_tpu_torch.utils.base58",
                "p2p_llm_chat_tpu_torch.p2p",
                "p2p_llm_chat_tpu_torch.p2p.addr",
                "p2p_llm_chat_tpu_torch.p2p.identity",
                "p2p_llm_chat_tpu_torch.p2p.devcrypto",
                "p2p_llm_chat_tpu_torch.p2p.udp",
                "p2p_llm_chat_tpu_torch.p2p.transport",
                "p2p_llm_chat_tpu_torch.p2p.natpmp",
                "p2p_llm_chat_tpu_torch.p2p.dht",
                "p2p_llm_chat_tpu_torch.directory",
                "p2p_llm_chat_tpu_torch.relay",
                "p2p_llm_chat_tpu_torch.node",
                "p2p_llm_chat_tpu_torch.ui",
                # Loadgen, the launcher and the end-to-end bench: host
                # code, no torch either.
                "p2p_llm_chat_tpu_torch.loadgen",
                "p2p_llm_chat_tpu_torch.loadgen.scenarios",
                "p2p_llm_chat_tpu_torch.loadgen.driver",
                "p2p_llm_chat_tpu_torch.loadgen.chaos",
                "p2p_llm_chat_tpu_torch.loadgen.report",
                "p2p_llm_chat_tpu_torch.loadgen.stub",
                "p2p_llm_chat_tpu_torch.start_all",
                "p2p_llm_chat_tpu_torch.tools.e2e_bench"}
    assert expected <= set(got["modules"])


_IMPORT_CHAT_PLANE = """
import json, sys
import p2p_llm_chat_tpu_torch.node, p2p_llm_chat_tpu_torch.ui
import p2p_llm_chat_tpu_torch.relay, p2p_llm_chat_tpu_torch.directory
from p2p_llm_chat_tpu_torch.utils import native
loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
    "torch", "jax", "jaxlib", "ml_dtypes", "p2p_llm_chat_tpu"))
import torch
print(json.dumps({"loaded": loaded, "cuda": torch.cuda.is_initialized(),
                  "built": sorted(native._cache)}))
"""


def test_importing_the_chat_plane_loads_no_torch_no_jax_no_cuda():
    """The chat plane is host code: a node, relay, directory or UI starts
    in a process that sees no card and never loads torch (nor JAX, nor
    the reference), and importing it builds no native library."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", _IMPORT_CHAT_PLANE], env=env,
                         cwd=str(ROOT), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"loaded": [], "cuda": False, "built": []}


_IMPORT_LOAD_PLANE = """
import json, sys
import p2p_llm_chat_tpu_torch.loadgen, p2p_llm_chat_tpu_torch.start_all
import p2p_llm_chat_tpu_torch.tools.e2e_bench
loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
    "torch", "jax", "jaxlib", "ml_dtypes", "p2p_llm_chat_tpu"))
print(json.dumps({"loaded": loaded}))
"""


def test_loadgen_launcher_and_bench_load_no_torch():
    """The load generator, the launcher and the end-to-end bench are host
    code: importing them loads neither torch nor JAX nor the reference
    (the bench draws its quote checkpoint in a subprocess)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", _IMPORT_LOAD_PLANE], env=env,
                         cwd=str(ROOT), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {"loaded": []}


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
            assert top not in ("jax", "jaxlib", "ml_dtypes",
                               "p2p_llm_chat_tpu", "safetensors",
                               "transformers", "tokenizers"), (f, name)


def test_kernel_sources_exist_for_every_kernel():
    from p2p_llm_chat_tpu_torch.ops import _build
    # Every CUDA source is built, and every built kernel has a source.
    assert set(_build.KERNELS) == {f.stem for f in
                                   _build.CSRC_DIR.glob("*.cu")}
    assert {"paged_attention", "w8a8_mm"} <= set(_build.KERNELS)
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

    q4 = torch.from_numpy(rng.integers(-128, 128, size=(2, 3, 32, 48),
                                       dtype=np.int8))
    s4 = torch.from_numpy(rng.random((2, 3, 2, 48), dtype=np.float32))
    s8 = torch.from_numpy(rng.random((2, 3, 1, 48), dtype=np.float32))
    xe = torch.from_numpy(rng.normal(size=(3, 4, 64)).astype(np.float32))
    for fn, args in (
            (quant_mm.quant_matmul4, (xe[0], q4[0, 0], s4[0, 0])),
            (quant_mm.quant_matmul_experts_stacked, (xe[:, :, :32], q4, s8,
                                                     1)),
            (quant_mm.quant_matmul_experts_stacked4, (xe, q4, s4, 1))):
        fn.launches = 0
        plain = getattr(quant_mm, fn.__name__ + "_reference")
        assert torch.equal(fn(*args), plain(*args))
    prefill_attention.launches = 0
    qa = torch.from_numpy(rng.normal(size=(2, 5, 4, 32)).astype(np.float32))
    assert torch.equal(prefill_attention(qa, ck[0, :, :9], ck[1, :, :9], 4),
                       prefill_attention_reference(qa, ck[0, :, :9],
                                                   ck[1, :, :9], 4))
    paged_attention.launches = 0
    pool = (qq, cache.k, cache.v, cache.page_table, cache.lengths + 1, 1)
    assert torch.equal(
        paged_attention(*pool, pages=2, impl="gather", k_scale=cache.k_scale,
                        v_scale=cache.v_scale),
        paged_attention_plain(*pool, pages=2, impl="gather",
                              k_scale=cache.k_scale, v_scale=cache.v_scale))
    w8a8_matmul.launches = 0
    xb = x.to(torch.bfloat16)
    assert torch.equal(w8a8_matmul(xb, q, s), w8a8_matmul_reference(xb, q, s))
    for fn in (quant_matmul, paged_attention_append, prefill_attention,
               paged_attention, w8a8_matmul, quant_mm.quant_matmul4,
               quant_mm.quant_matmul_experts_stacked,
               quant_mm.quant_matmul_experts_stacked4):
        assert fn.launches == 0, fn.__name__


def test_dense_wrappers_take_plain_path_on_cpu_and_count_nothing():
    """The dense path's wrappers (ops/dense_attention.py) run their plain
    versions on CPU tensors, launch nothing, are listed among the
    serving path's wrappers, and refuse a device that is neither."""
    from p2p_llm_chat_tpu_torch import ops
    from p2p_llm_chat_tpu_torch.models.llama import KVCache
    from p2p_llm_chat_tpu_torch.ops import dense_attention as da
    rng = np.random.default_rng(1)
    cfg = get_config("tiny")
    cache = KVCache.create(cfg, 2, 40, dtype=torch.float32, device="cpu")
    cache.k.copy_(torch.from_numpy(rng.normal(size=cache.k.shape)))
    cache.v.copy_(torch.from_numpy(rng.normal(size=cache.v.shape)))
    lens = torch.tensor([7, 33], dtype=torch.int32)
    q = torch.from_numpy(rng.normal(size=(2, 4, 32)).astype(np.float32))
    qb = torch.from_numpy(rng.normal(size=(2, 3, 4, 32)).astype(np.float32))
    kb = torch.from_numpy(rng.normal(size=(2, 3, 2, 32)).astype(np.float32))
    da.dense_attention.launches = 0
    da.dense_attention_verify.launches = 0
    assert torch.equal(
        da.dense_attention(q, cache, lens, 1, window=40),
        da.dense_attention_plain(q, cache.k, cache.v, lens, 1, window=40))
    assert torch.equal(
        da.dense_attention_verify(qb, kb, kb, cache, lens, 1, window=40),
        da.dense_attention_verify_plain(qb, kb, kb, cache.k, cache.v, lens,
                                        1, window=40))
    assert da.dense_attention.launches == 0
    assert da.dense_attention_verify.launches == 0
    names = ops.wrappers()
    assert names["dense_attention"] is da.dense_attention
    assert names["dense_attention_verify"] is da.dense_attention_verify
    meta = q.to("meta")
    for call in (lambda: da.dense_attention(meta, cache, lens, 1, window=40),
                 lambda: da.dense_attention_verify(
                     qb.to("meta"), kb, kb, cache, lens, 1, window=40)):
        try:
            call()
        except ValueError as e:
            assert "unsupported device" in str(e)
        else:
            raise AssertionError("a meta tensor was served")


def test_chip_smoke_refuses_to_run_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")     # hide any card
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=str(ROOT), env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout

"""The port stands apart from the JAX package and from the CPU.

- Importing every module of ``llms_on_kubernetes_tpu_torch`` (and
  ``chip_smoke.py``) imports no JAX, and neither ``transformers``,
  ``tokenizers`` nor PIL (the card's machine has no PIL: the vision path
  reads images with ``engine/images.py``). This runs in a subprocess: this
  test process has JAX loaded by tests/conftest.py.
- No source file of the port imports ``jax``, the JAX package or PIL, and
  every CUDA source under ``csrc/`` is one the port builds and binds.
- Without a GPU, every entry point that defaults to ``device="cuda"``
  raises instead of carrying on on the CPU.
"""

import ctypes
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "llms_on_kubernetes_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = re.compile(
    r"^\s*(?:from|import)\s+(?:jax\b|jaxlib\b|llms_on_kubernetes_tpu(?!_torch)\b|PIL\b)",
    re.M)


def test_import_everything_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import llms_on_kubernetes_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "from llms_on_kubernetes_tpu_torch.ops.paged_attention import (\n"
        "    paged_decode_attention_int8, paged_decode_attention_write_int8)\n"
        "from llms_on_kubernetes_tpu_torch.engine.cache import quantize_kv\n"
        "from llms_on_kubernetes_tpu_torch.ops.paged_write import (\n"
        "    dispatch_write_window, paged_write_window, paged_write_window_int8)\n"
        "from llms_on_kubernetes_tpu_torch.models.decoder import forward_chunk\n"
        "from llms_on_kubernetes_tpu_torch.engine.graphs import DecodeWindow, decode_window\n"
        "from llms_on_kubernetes_tpu_torch.ops.quant import QTensor, quantize_params, w8_matmul\n"
        "from llms_on_kubernetes_tpu_torch.server.metrics import (\n"
        "    Registry, build_info_metrics, engine_metrics)\n"
        "from llms_on_kubernetes_tpu_torch.server.affinity import BloomFilter\n"
        "from llms_on_kubernetes_tpu_torch.models.decoder import forward_score\n"
        "from llms_on_kubernetes_tpu_torch import faults\n"
        "from llms_on_kubernetes_tpu_torch.server.tracing import TraceStore, reconcile\n"
        "from llms_on_kubernetes_tpu_torch.engine.tokenizer import JsonTokenizer\n"
        "from llms_on_kubernetes_tpu_torch.engine.ledger import GoodputLedger, detect_peak\n"
        "from llms_on_kubernetes_tpu_torch.engine.grammar import (\n"
        "    compile_response_format, compile_tool_choice, token_bytes_of)\n"
        "from llms_on_kubernetes_tpu_torch.engine.graphs import fsm_apply, fsm_scatter\n"
        "from llms_on_kubernetes_tpu_torch.server.tools import ToolStreamParser\n"
        "from llms_on_kubernetes_tpu_torch.server.profiling import ProfileManager\n"
        "from llms_on_kubernetes_tpu_torch.server.runtime_telemetry import RuntimeTelemetry\n"
        "from llms_on_kubernetes_tpu_torch.testing.synth_checkpoint import (\n"
        "    TOKENIZER_PROBES, write_tokenizer)\n"
        "from llms_on_kubernetes_tpu_torch.engine.images import decode_png, resize_bicubic\n"
        "from llms_on_kubernetes_tpu_torch.engine.images import (\n"
        "    decode_apng_frames, decode_image, decode_video_frames, video_frames)\n"
        "from llms_on_kubernetes_tpu_torch.engine.jpeg import decode_jpeg, idct_islow\n"
        "from llms_on_kubernetes_tpu_torch.engine.gif import decode_gif, decode_gif_frames\n"
        "from llms_on_kubernetes_tpu_torch.testing.synth_media import (\n"
        "    encode_apng, encode_gif, encode_jpeg)\n"
        "from llms_on_kubernetes_tpu_torch.models.vision import encode_video_qwen3vl\n"
        "from llms_on_kubernetes_tpu_torch.models.vision import (\n"
        "    encode_images, encode_images_qwen3vl, qwen_mrope_positions)\n"
        "from llms_on_kubernetes_tpu_torch.models.decoder import forward_prefill_mm\n"
        "from llms_on_kubernetes_tpu_torch.ops.rope import apply_mrope\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'llms_on_kubernetes_tpu'\n"
        "             or m.startswith('llms_on_kubernetes_tpu.'))\n"
        "assert not bad, bad\n"
        "heavy = sorted(m for m in ('transformers', 'tokenizers', 'PIL') if m in sys.modules)\n"
        "assert not heavy, heavy\n"
        "assert len(mods) >= 15, mods\n"
        "print(len(mods))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]


def test_the_framework_free_copies_are_scanned():
    """The port keeps its own copies of the JAX package's framework-free
    modules (the server's metrics, affinity, tracing and tools, the
    engine's ledger and grammar, ``faults.py``) and ports profiling and
    runtime telemetry; the scan below covers them."""
    assert {PKG / "server" / "metrics.py", PKG / "server" / "affinity.py",
            PKG / "server" / "tracing.py", PKG / "faults.py", PKG / "server" / "tools.py",
            PKG / "engine" / "ledger.py", PKG / "engine" / "grammar.py",
            PKG / "server" / "profiling.py",
            PKG / "server" / "runtime_telemetry.py", PKG / "engine" / "images.py",
            PKG / "models" / "vision.py", PKG / "engine" / "jpeg.py", PKG / "engine" / "gif.py",
            PKG / "testing" / "synth_media.py"} <= set(SOURCES)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path} imports {hits}"


def test_every_kernel_source_is_built_and_bound():
    """Each ``csrc/*.cu`` is a library ``kernels.build()`` compiles (in
    parallel, one nvcc each) and has a C entry with its ctypes signature;
    the headers it includes count in the build's source hash."""
    from llms_on_kubernetes_tpu_torch import kernels

    cu = sorted(p.stem for p in (PKG / "csrc").glob("*.cu"))
    assert sorted(kernels.SOURCES) == cu
    assert set(kernels._SIGNATURES) == set(kernels.SOURCES)
    hashed = {p.name for p in kernels.CSRC.glob("*.cu*")}
    assert {"common.cuh", "paged_decode.cuh", "paged_decode_int8.cu", "quantize.cuh",
            "paged_write_window.cu", "w8_matmul.cu"} <= hashed
    # kernels 5 and 7 quantize with quantize.cuh's device functions: the
    # warp-a-row quantize_row and its 16-bytes-a-lane twin quantize_vec
    quant = (PKG / "csrc" / "quantize.cuh").read_text()
    assert "float quantize_row(" in quant and "float quantize_vec(" in quant
    for src, fn in (("paged_decode.cuh", "quantize_row<"), ("paged_write_window.cu",
                                                          "quantize_vec<")):
        text = (PKG / "csrc" / src).read_text()
        assert '#include "quantize.cuh"' in text and fn in text, src
    assert "--use_fast_math" not in kernels.NVCC_FLAGS      # IEEE division


_C_TYPES = {"const void*": "c_void_p", "void*": "c_void_p", "int": "c_int", "float": "c_float"}


def test_ctypes_signatures_match_the_c_entries():
    """Each C entry's parameter list, read from its source, is the ctypes
    signature the wrapper binds: a pointer passed as a 32-bit int, or a
    missing argument, would corrupt a launch without an error."""
    from llms_on_kubernetes_tpu_torch import kernels

    for name, (symbol, argtypes) in kernels._SIGNATURES.items():
        text = (PKG / "csrc" / f"{name}.cu").read_text()
        m = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", text)
        assert m, symbol
        params = [re.sub(r"\s+\w+$", "", p.strip()) for p in m.group(1).split(",")]
        assert [_C_TYPES[p] for p in params] == [a.__name__ for a in argtypes], symbol


def _host_kind(c_type: str) -> str:
    """A C parameter type as what ctypes must pass: a pointer, an int64 or
    an int32."""
    if "*" in c_type:
        return "pointer"
    return {"int64_t": "int64", "int32_t": "int32"}[c_type]


def _ctypes_kind(t) -> str:
    if t in (ctypes.c_char_p, ctypes.c_void_p) or hasattr(t, "contents"):
        return "pointer"
    return {ctypes.sizeof(ctypes.c_int64): "int64", 4: "int32"}[ctypes.sizeof(t)]


def test_host_ctypes_signatures_match_the_c_entries():
    """Each entry of the host library (``csrc/host/media.c``, the media
    decoders' entropy stages) is bound with the ctypes signature its C
    parameter list asks for, and every host source is one the port binds."""
    from llms_on_kubernetes_tpu_torch import kernels

    assert sorted(p.stem for p in kernels.HOST_CSRC.glob("*.c")) == sorted(
        {lib for lib, _ in kernels._HOST_SIGNATURES.values()})
    for symbol, (lib, argtypes) in kernels._HOST_SIGNATURES.items():
        text = (kernels.HOST_CSRC / f"{lib}.c").read_text()
        m = re.search(r"LLMK_API int " + symbol + r"\(([^)]*)\)", text)
        assert m, symbol
        params = [re.sub(r"\s*\w+$", "", p.strip()) for p in m.group(1).split(",")]
        assert [_host_kind(p) for p in params] == [_ctypes_kind(a) for a in argtypes], symbol


def test_forbidden_pattern_catches_what_it_should():
    for bad in ("import jax", "from jax import numpy", "import jax.numpy as jnp",
                "from llms_on_kubernetes_tpu.ops import attention",
                "    import llms_on_kubernetes_tpu", "from PIL import Image", "import PIL"):
        assert FORBIDDEN.search(bad), bad
    for ok in ("from llms_on_kubernetes_tpu_torch import kernels",
               "import llms_on_kubernetes_tpu_torch.ops", "import jaxtyping"):
        assert not FORBIDDEN.search(ok), ok


def _entry_points():
    from llms_on_kubernetes_tpu_torch import cli, resolve_device
    from llms_on_kubernetes_tpu_torch.configs import get_config
    from llms_on_kubernetes_tpu_torch.engine.cache import CacheConfig, init_pages
    from llms_on_kubernetes_tpu_torch.engine.engine import Engine, EngineConfig
    from llms_on_kubernetes_tpu_torch.engine.weights import params_from_numpy
    from llms_on_kubernetes_tpu_torch.models.decoder import init_params
    from llms_on_kubernetes_tpu_torch.server.openai_api import serve

    cfg = get_config("debug-tiny")
    return {
        "resolve_device": lambda: resolve_device(),
        "Engine": lambda: Engine(EngineConfig(model="debug-tiny")),
        "Engine int8 KV": lambda: Engine(EngineConfig(model="debug-tiny",
                                                      kv_cache_dtype="int8")),
        "init_params": lambda: init_params(cfg),
        "init_pages": lambda: init_pages(CacheConfig(2, 2, 16, num_pages=4)),
        "init_pages int8": lambda: init_pages(CacheConfig(2, 2, 16, num_pages=4,
                                                          kv_dtype="int8")),
        "params_from_numpy": lambda: params_from_numpy({"w": __import__("numpy").ones(2)}),
        "serve": lambda: serve("debug-tiny", random_weights=True, port=0),
        "cli": lambda: cli.main(["serve", "--model", "debug-tiny", "--random-weights",
                                 "--port", "0"]),
        "cli int8 KV": lambda: cli.main(["serve", "--model", "debug-tiny", "--random-weights",
                                         "--port", "0", "--kv-cache-dtype", "int8"]),
    }


@pytest.mark.parametrize("name", ["resolve_device", "Engine", "Engine int8 KV", "init_params",
                                  "init_pages", "init_pages int8", "params_from_numpy",
                                  "serve", "cli", "cli int8 KV"])
def test_entry_points_refuse_a_missing_gpu(name):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        _entry_points()[name]()


def test_cli_refuses_to_serve_without_weights(capsys):
    from llms_on_kubernetes_tpu_torch import cli

    assert cli.main(["serve", "--model", "debug-tiny", "--device", "cpu"]) == 1
    assert "--random-weights" in capsys.readouterr().err


def test_configs_match_the_jax_registry():
    """The port's copy of the registry: every entry equals the JAX one."""
    import dataclasses

    from llms_on_kubernetes_tpu import configs as jconfigs
    from llms_on_kubernetes_tpu_torch import configs as tconfigs

    for name, tcfg in tconfigs.REGISTRY.items():
        jcfg = jconfigs.get_config(name)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg), name
    for alias, name in tconfigs.ALIASES.items():
        assert jconfigs.ALIASES[alias] == name
    with pytest.raises(KeyError):
        tconfigs.get_config("no-such-model")


def test_byte_tokenizer_matches_jax():
    from llms_on_kubernetes_tpu.engine.tokenizer import ByteTokenizer as JTok
    from llms_on_kubernetes_tpu_torch.engine.tokenizer import ByteTokenizer, load_tokenizer

    t, j = ByteTokenizer(), JTok()
    msgs = [{"role": "system", "content": "be brief"}, {"role": "user", "content": "héllo ☃"}]
    assert t.apply_chat_template(msgs) == j.apply_chat_template(msgs)
    assert t.encode("héllo") == j.encode("héllo")
    assert t.decode(t.encode("héllo ☃") + [256, 257]) == j.decode(j.encode("héllo ☃"))
    assert t.eos_ids == j.eos_ids
    assert isinstance(load_tokenizer("llama-3-8b"), ByteTokenizer)

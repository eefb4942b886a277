"""The port stands apart from the JAX package and from the CPU.

- Importing every module of ``llms_on_kubernetes_tpu_torch`` (and
  ``chip_smoke.py``) imports no JAX. This runs in a subprocess: this test
  process has JAX loaded by tests/conftest.py.
- No source file of the port imports ``jax`` or the JAX package.
- Without a GPU, every entry point that defaults to ``device="cuda"``
  raises instead of carrying on on the CPU.
"""

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
    r"^\s*(?:from|import)\s+(?:jax\b|jaxlib\b|llms_on_kubernetes_tpu(?!_torch)\b)", re.M)


def test_import_everything_without_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import llms_on_kubernetes_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'llms_on_kubernetes_tpu'\n"
        "             or m.startswith('llms_on_kubernetes_tpu.'))\n"
        "assert not bad, bad\n"
        "assert len(mods) >= 15, mods\n"
        "print(len(mods))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path} imports {hits}"


def test_forbidden_pattern_catches_what_it_should():
    for bad in ("import jax", "from jax import numpy", "import jax.numpy as jnp",
                "from llms_on_kubernetes_tpu.ops import attention",
                "    import llms_on_kubernetes_tpu"):
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
        "init_params": lambda: init_params(cfg),
        "init_pages": lambda: init_pages(CacheConfig(2, 2, 16, num_pages=4)),
        "params_from_numpy": lambda: params_from_numpy({"w": __import__("numpy").ones(2)}),
        "serve": lambda: serve("debug-tiny", random_weights=True, port=0),
        "cli": lambda: cli.main(["serve", "--model", "debug-tiny", "--random-weights",
                                 "--port", "0"]),
    }


@pytest.mark.parametrize("name", ["resolve_device", "Engine", "init_params", "init_pages",
                                  "params_from_numpy", "serve", "cli"])
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

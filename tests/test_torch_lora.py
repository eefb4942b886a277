"""The port's multi-tenant LoRA against the JAX package, on the CPU
(counterparts of tests/test_lora_ops.py, tests/test_adapters.py and
tests/test_engine_lora.py): the rank-space equations and the per-row
delta over bf16, int8 and packed int4 bases, the PEFT loader and its
rejections, the slot LRU, the engine (held to the JAX engine's streams in
float32), the prefix-cache salt, and the server's ``base:adapter`` surface.

Adapters are written by ``testing/synth_adapter.py`` (through the port's
own safetensors header writer; the JAX loader reads the same files with
the ``safetensors`` package). Tolerances:
- ``_delta_eqs``, the loaded factors: exactly;
- the delta and the projection with it against JAX ``lora_delta`` /
  ``lora_qeinsum``: float32 rtol = atol = 1e-5 (summation order only);
  bfloat16 each row's max |err| <= 2e-2 x the row's own max |JAX|; a base
  row (idx -1) adds exactly nothing;
- engine streams: greedy tokens exactly (float32).
"""

import json
import os
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llms_on_kubernetes_tpu.configs import get_config as jget_config
from llms_on_kubernetes_tpu.engine import adapters as jadapters
from llms_on_kubernetes_tpu.engine.engine import Engine as JEngine
from llms_on_kubernetes_tpu.engine.engine import EngineConfig as JEngineConfig
from llms_on_kubernetes_tpu.engine.engine import SamplingParams as JSamplingParams
from llms_on_kubernetes_tpu.ops import lora as jlora
from llms_on_kubernetes_tpu.ops import quant as jquant
from llms_on_kubernetes_tpu_torch.configs import get_config
from llms_on_kubernetes_tpu_torch.engine.adapters import (
    AdapterError, AdapterManager, LoadedAdapter, load_adapter,
)
from llms_on_kubernetes_tpu_torch.engine.engine import (
    Engine, EngineConfig, SamplingParams, UnknownAdapterError,
)
from llms_on_kubernetes_tpu_torch.engine.safetensors import SafetensorsFile
from llms_on_kubernetes_tpu_torch.engine.tokenizer import ByteTokenizer
from llms_on_kubernetes_tpu_torch.engine.weights import params_from_numpy
from llms_on_kubernetes_tpu_torch.models import decoder as tdec
from llms_on_kubernetes_tpu_torch.ops import lora as tlora
from llms_on_kubernetes_tpu_torch.ops import quant as tquant
from llms_on_kubernetes_tpu_torch.server.openai_api import OpenAIServer
from llms_on_kubernetes_tpu_torch.testing.synth_adapter import write_peft, write_safetensors

CFG = get_config("debug-tiny")
JCFG = jget_config("debug-tiny")
PROMPT = [3, 17, 9, 42, 7]

# the decoder's equations: name -> (equation, x dims, in shape, out shape)
EQS = {"wq": ("btd,dhk->bthk", (64,), (4, 16)), "wk": ("btd,dhk->bthk", (64,), (2, 16)),
       "wv": ("btd,dhk->bthk", (64,), (2, 16)), "wo": ("bthk,hkd->btd", (4, 16), (64,)),
       "w_gate": ("btd,df->btf", (64,), (128,)), "w_up": ("btd,df->btf", (64,), (128,)),
       "w_down": ("btf,fd->btd", (128,), (64,))}


def peft(path, **kw):
    return write_peft(path, CFG, **kw)


# ---------------------------------------------------------------------------
# the delta
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eq", sorted({e for e, _, _ in EQS.values()}))
def test_delta_eqs_equal_jax(eq):
    assert tlora._delta_eqs(eq) == jlora._delta_eqs(eq)


def _stack(rng, in_shape, out_shape, S=3, r=4):
    a = (0.3 * rng.standard_normal((S, *in_shape, r))).astype(np.float32)
    b = (0.3 * rng.standard_normal((S, r, *out_shape))).astype(np.float32)
    a[1] = 0.0   # a vacant slot
    b[1] = 0.0
    return a, b


IDX = np.asarray([2, -1, 0, 2, 1], np.int32)     # mixed rows, a base row, a vacant slot


@pytest.mark.parametrize("name", list(EQS))
def test_lora_delta_equals_jax(rng, name):
    eq, in_shape, out_shape = EQS[name]
    a, b = _stack(rng, in_shape, out_shape)
    x = rng.normal(size=(len(IDX), 3, *in_shape)).astype(np.float32)
    want = np.asarray(jlora.lora_delta(eq, jnp.asarray(x), jlora.LoRAStack(a, b),
                                       jnp.asarray(IDX)))
    got = tlora.lora_delta(eq, torch.from_numpy(x),
                           tlora.LoRAStack(torch.from_numpy(a), torch.from_numpy(b)),
                           torch.from_numpy(IDX)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert not got[IDX < 0].any() and not got[IDX == 1].any()   # exactly nothing added


def _bases(rng, name, in_shape, out_shape):
    """(label, JAX weight, port weight, dtype) for one target: a dense
    float32 and bfloat16 weight, an int8 QTensor and a packed4 GroupQTensor."""
    K, N = int(np.prod(in_shape)), int(np.prod(out_shape))
    w = (rng.normal(size=(*in_shape, *out_shape)) / np.sqrt(K)).astype(np.float32)
    out = [("f32", jnp.asarray(w), torch.from_numpy(w), "float32"),
           ("bf16", jnp.asarray(w).astype(jnp.bfloat16),
            torch.from_numpy(w).to(torch.bfloat16), "bfloat16")]
    n_in = len(in_shape)
    jq = jquant.quantize(w, tuple(range(n_in)))
    out.append(("int8", jq, tquant.QTensor(torch.from_numpy(np.asarray(jq.data)),
                                           torch.from_numpy(np.asarray(jq.scale))), "float32"))
    qw = rng.integers(-2 ** 31, 2 ** 31, size=(K, N // 8), dtype=np.int64).astype(np.int32)
    qz = rng.integers(-2 ** 31, 2 ** 31, size=(K // 16, N // 8),
                      dtype=np.int64).astype(np.int32)
    s = rng.uniform(1e-3, 1e-2, size=(K // 16, N)).astype(np.float16)
    out.append(("packed4", jquant.awq_group_tensors(qw, qz, s, out_shape=out_shape),
                tquant.awq_group_tensors(torch.from_numpy(qw), torch.from_numpy(qz),
                                         torch.from_numpy(s), out_shape=out_shape), "float32"))
    return out


@pytest.mark.parametrize("name", list(EQS))
def test_projection_with_lora_equals_lora_qeinsum(rng, name):
    """``decoder._proj`` with a stack and mixed slots over every base kind:
    JAX's ``lora_qeinsum`` (base + f32 delta, cast to the base's dtype);
    a base row (-1) is the base projection bit for bit."""
    eq, in_shape, out_shape = EQS[name]
    a, b = _stack(rng, in_shape, out_shape)
    jst = jlora.LoRAStack(a, b)
    tst = tlora.LoRAStack(torch.from_numpy(a), torch.from_numpy(b))
    x = rng.normal(size=(len(IDX), 3, *in_shape)).astype(np.float32)
    for label, jw, tw, dt in _bases(rng, name, in_shape, out_shape):
        jdt, tdt = (jnp.float32, torch.float32) if dt == "float32" else (jnp.bfloat16,
                                                                       torch.bfloat16)
        xj, xt = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)
        want = np.asarray(jlora.lora_qeinsum(eq, xj, jw, jst, jnp.asarray(IDX))
                          .astype(jnp.float32))
        got_t = tdec._proj(xt, tw, len(in_shape), tst, torch.from_numpy(IDX))
        assert got_t.dtype == tdt, label
        got = got_t.float().numpy()
        if dt == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=label)
        else:
            g, w = got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])
            err = np.abs(g - w).max(axis=1)
            assert (err <= 2e-2 * np.abs(w).max(axis=1)).all(), (label, err.max())
        base = tdec._proj(xt, tw, len(in_shape))
        assert torch.equal(got_t[torch.from_numpy(IDX < 0)], base[torch.from_numpy(IDX < 0)])


def test_merge_delta_equals_jax(rng):
    a = rng.normal(size=(4, 16, 3)).astype(np.float32)
    b = rng.normal(size=(3, 64)).astype(np.float32)
    np.testing.assert_allclose(tlora.merge_delta(torch.from_numpy(a), torch.from_numpy(b))
                               .numpy(), np.asarray(jlora.merge_delta(a, b)), rtol=1e-6)


# ---------------------------------------------------------------------------
# the PEFT loader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("modules,targets", [
    (("q", "k", "v", "o"), ("wq", "wk", "wv", "wo")),
    (("q", "v", "gate", "up", "down"), tuple(jadapters.PEFT_MODULES))])
def test_load_adapter_equals_jax(tmp_path, modules, targets):
    """Padded to the stack rank, alpha/r folded into b, in the decoder's
    layouts: JAX's factors bit for bit, from a file the JAX loader reads
    with the safetensors package."""
    d = peft(tmp_path / "ad", rank=2, alpha=8, modules=modules)
    got = load_adapter("ad", d, CFG, max_rank=4, targets=targets)
    want = jadapters.load_adapter("ad", d, JCFG, max_rank=4, targets=targets)
    assert (got.rank, got.alpha) == (want.rank, want.alpha) == (2, 8.0)
    assert set(got.factors) == set(want.factors)
    for t, (wa, wb) in want.factors.items():
        np.testing.assert_array_equal(got.factors[t][0], wa)
        np.testing.assert_array_equal(got.factors[t][1], wb)
    a, b = got.factors["wq"]
    assert a.shape == (2, 64, 4) and b.shape == (2, 4, 4, 16)
    assert not a[..., 2:].any() and not b[:, 2:].any()


def test_peft_files_read_by_the_port_reader(tmp_path):
    d = peft(tmp_path / "ad", rank=2)
    f = SafetensorsFile(os.path.join(d, "adapter_model.safetensors"))
    key = "base_model.model.model.layers.1.self_attn.o_proj.lora_B.weight"
    assert tuple(f.tensor(key).shape) == (64, 2) and f.tensor(key).dtype == torch.float32
    assert json.load(open(os.path.join(d, "adapter_config.json"))) == {"r": 2, "lora_alpha": 8}


def _reject(d, match, **kw):
    kw.setdefault("max_rank", 4)
    with pytest.raises(AdapterError, match=match):
        load_adapter("ad", str(d), CFG, **kw)
    with pytest.raises(jadapters.AdapterError, match=match):
        jadapters.load_adapter("ad", str(d), JCFG, **kw)


def test_corrupt_safetensors_rejected(tmp_path):
    d = peft(tmp_path / "ad")
    with open(os.path.join(d, "adapter_model.safetensors"), "wb") as f:
        f.write(b"not a safetensors file")
    _reject(d, "cannot read")


def test_bad_config_rejected(tmp_path):
    d = peft(tmp_path / "ad", config={"r": 0})
    _reject(d, "invalid rank")
    with open(os.path.join(d, "adapter_config.json"), "w") as f:
        f.write("{broken")
    _reject(d, "adapter_config")


def test_rank_mismatch_rejected(tmp_path):
    _reject(peft(tmp_path / "ad", rank=2, config={"r": 4, "lora_alpha": 8}),
            "rank/shape mismatch", max_rank=8)


def test_rank_above_capacity_rejected(tmp_path):
    _reject(peft(tmp_path / "ad", rank=8), "exceeds the engine's")


def test_disabled_target_rejected(tmp_path):
    _reject(peft(tmp_path / "ad", modules=("q", "gate")), "not enabled",
            targets=("wq", "wk", "wv", "wo"))


def test_half_pair_rejected(tmp_path):
    d = peft(tmp_path / "ad", rank=2)
    path = os.path.join(d, "adapter_model.safetensors")
    f = SafetensorsFile(path)
    tensors = {k: f.tensor(k).numpy().copy() for k in f.keys()
               if not k.endswith("q_proj.lora_B.weight") or ".layers.0." not in k}
    del f
    write_safetensors(path, tensors)
    _reject(d, "lora_B missing")


def test_layer_out_of_range_rejected(tmp_path):
    _reject(peft(tmp_path / "ad", layers=CFG.num_layers + 1), "out of range")


def test_unrecognized_and_unsupported_tensors_rejected(tmp_path):
    d = peft(tmp_path / "ad", rank=2)
    path = os.path.join(d, "adapter_model.safetensors")
    write_safetensors(path, {"base_model.model.lm_head.lora_A.weight":
                             np.zeros((2, 64), np.float32)})
    _reject(d, "unrecognized tensor")
    write_safetensors(path, {})
    _reject(d, "no LoRA tensors")


# ---------------------------------------------------------------------------
# the slot LRU (AdapterManager, a copy of the JAX one)
# ---------------------------------------------------------------------------

def make_manager(num_slots, cls=AdapterManager, loaded=LoadedAdapter,
                 names=("a", "b", "c", "d")):
    loads, uploads = [], []

    def loader(name, ref):
        loads.append(name)
        return loaded(name=name, rank=2, alpha=4)

    def upload(slot, la):
        uploads.append((slot, la.name))

    return cls({n: f"/fake/{n}" for n in names}, num_slots, loader, upload), loads, uploads


def _script(mgr):
    """One sequence of acquires and releases; the trace of every result."""
    out = []
    s_a = mgr.acquire("a")
    s_b = mgr.acquire("b")
    out += [s_a, s_b]
    mgr.release(s_b)
    out.append(mgr.acquire("c"))          # b's slot (a is pinned)
    out.append(mgr.acquire("d"))          # every slot pinned: None
    mgr.release(s_a)
    out.append(mgr.acquire("d"))          # a's slot
    out.append(mgr.acquire("d"))          # a hit: refcount 2
    out += [list(mgr.slot_name), list(mgr.slot_refs), dict(mgr.stats)]
    for s in range(mgr.num_slots):
        while mgr.slot_refs[s]:
            mgr.release(s)
    out.append(mgr.acquire("a"))          # reload: the host cache, no disk read
    return out


def test_manager_trace_equals_jax():
    got, g_loads, g_up = make_manager(2)
    want, w_loads, w_up = make_manager(2, jadapters.AdapterManager, jadapters.LoadedAdapter)
    assert _script(got) == _script(want)
    assert (g_loads, g_up) == (w_loads, w_up)
    assert g_loads == ["a", "b", "c", "d"]          # "a" reloaded from the host cache
    assert len(got.load_times) == len(g_up)


def test_lru_evicts_least_recently_used():
    mgr, _, uploads = make_manager(2)
    s_a, s_b = mgr.acquire("a"), mgr.acquire("b")
    mgr.release(s_a)
    mgr.release(s_b)
    mgr.release(mgr.acquire("a"))          # "b" becomes the least recently used
    s_c = mgr.acquire("c")
    assert s_c == s_b and mgr.slot_name[s_a] == "a"
    assert mgr.stats == {"hits": 1, "misses": 3, "evictions": 1}
    assert uploads[-1] == (s_b, "c")
    with pytest.raises(KeyError):
        mgr.acquire("nope")


# ---------------------------------------------------------------------------
# the engine, against the JAX engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def adapter_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("adapters")
    return {f"ad{i}": peft(root / f"ad{i}", rank=2, alpha=16, seed=10 + i) for i in range(3)}


ENGINE = dict(model="debug-tiny", dtype="float32", max_decode_slots=4, page_size=16,
              pages_per_slot=8, num_pages=4 * 8 + 1, prefill_buckets=(16,),
              adapter_slots=2, adapter_rank=4)


@pytest.fixture(scope="module")
def shared_params():
    """Seeded debug-tiny weights, as JAX arrays and as the port's tensors."""
    from llms_on_kubernetes_tpu.models.decoder import init_params

    jp = init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def engines(adapter_dirs, shared_params, **kw):
    jp, tp = shared_params
    cfg = {**ENGINE, "adapters": adapter_dirs, **kw}
    return (JEngine(JEngineConfig(**cfg), params=jax.tree.map(lambda a: a, jp)),
            Engine(EngineConfig(**cfg, device="cpu"), params=tp))


def greedy(eng, sp_cls, adapter=None, max_tokens=8, prompt=PROMPT):
    return eng.generate(prompt, sp_cls(temperature=0.0, max_tokens=max_tokens),
                        adapter=adapter)


@pytest.mark.parametrize("kw", [dict(), dict(async_scheduling=False)], ids=["async", "sync"])
def test_adapter_streams_equal_jax_and_reload(adapter_dirs, shared_params, kw):
    """Each adapter alone, through 2 slots (the third evicts; ad0 comes
    back from the host cache): the JAX engine's streams; the adapters
    change the output; the base rows are untouched."""
    je, te = engines(adapter_dirs, shared_params, **kw)
    order = [None, "ad0", "ad1", "ad2", "ad0", None]
    want = [greedy(je, JSamplingParams, a) for a in order]
    got = [greedy(te, SamplingParams, a) for a in order]
    assert got == want
    assert got[1] == got[4] and got[0] == got[5] and len({tuple(g) for g in got[:4]}) == 4
    assert te.adapters.stats == je.adapters.stats
    assert te.adapters.stats["evictions"] >= 1
    assert all(t >= 0 for t in te.adapters.load_times)


def test_heterogeneous_batch_equals_jax_and_alone(adapter_dirs, shared_params):
    """base, ad0 and ad1 in one batch (every window applies both deltas):
    each stream equals its run alone, and the JAX engine's batch."""
    je, te = engines(adapter_dirs, shared_params)
    alone = {a: greedy(te, SamplingParams, a) for a in ("ad0", "ad1", None)}

    def batch(eng, sp_cls):
        reqs = {a: eng.submit(PROMPT, sp_cls(temperature=0.0, max_tokens=8), adapter=a)
                for a in ("ad0", "ad1", None)}
        while any(not r.finished for r in reqs.values()):
            eng.step()
        return {a: r.output for a, r in reqs.items()}

    got = batch(te, SamplingParams)
    assert got == alone == batch(je, JSamplingParams)
    assert all(refs == 0 for refs in te.adapters.slot_refs)
    assert sorted(n for n in te.adapters.slot_name if n) == ["ad0", "ad1"]


def test_pinned_slots_make_admission_wait(adapter_dirs, shared_params):
    """Three adapters on two slots at once: the third request waits for a
    pin to go, as under page pressure, then runs its own stream."""
    _je, te = engines(adapter_dirs, shared_params)
    alone = {a: greedy(te, SamplingParams, a, max_tokens=6) for a in ("ad0", "ad1", "ad2")}
    reqs = {a: te.submit(PROMPT, SamplingParams(temperature=0.0, max_tokens=6), adapter=a)
            for a in ("ad0", "ad1", "ad2")}
    te.step()
    assert reqs["ad2"].slot < 0 and reqs["ad2"].adapter_slot < 0
    while any(not r.finished for r in reqs.values()):
        te.step()
    assert {a: r.output for a, r in reqs.items()} == alone


def test_unknown_adapter_and_bad_config(adapter_dirs, shared_params):
    _je, te = engines(adapter_dirs, shared_params)
    with pytest.raises(UnknownAdapterError, match="not served"):
        te.submit(PROMPT, SamplingParams(max_tokens=4), adapter="nope")
    assert isinstance(UnknownAdapterError("x"), LookupError)
    plain = Engine(EngineConfig(**{k: v for k, v in ENGINE.items() if "adapter" not in k},
                                device="cpu"), params=shared_params[1])
    assert plain.adapters is None and "lora_wq" not in plain.params["layers"]
    with pytest.raises(UnknownAdapterError):
        plain.submit(PROMPT, SamplingParams(max_tokens=4), adapter="ad0")
    for bad in ({"with:colon": "/x"}, {"white space": "/x"}, {"": "/x"}):
        with pytest.raises(ValueError):
            EngineConfig(model="debug-tiny", adapters=bad, device="cpu")
    with pytest.raises(ValueError, match="adapter_slots"):
        EngineConfig(model="debug-tiny", adapters={"a": "/x"}, adapter_slots=0, device="cpu")
    with pytest.raises(ValueError, match="unknown adapter target"):
        Engine(EngineConfig(**ENGINE, adapters=adapter_dirs, adapter_targets=("wz",),
                            device="cpu"), params=shared_params[1])


def test_stacks_are_never_reassigned(adapter_dirs, shared_params):
    """Uploads copy into the stacks allocated at construction (a captured
    window holds their addresses); the caller's params stay adapter-free."""
    _je, te = engines(adapter_dirs, shared_params)
    stack = te.params["layers"]["lora_wq"]
    ptrs = (stack.a.data_ptr(), stack.b.data_ptr())
    for a in ("ad0", "ad1", "ad2", "ad0"):
        greedy(te, SamplingParams, a, max_tokens=2)
    assert te.params["layers"]["lora_wq"] is stack
    assert (stack.a.data_ptr(), stack.b.data_ptr()) == ptrs
    assert "lora_wq" not in shared_params[1]["layers"]


def test_prefix_hit_adapter_stream_equals_cold(adapter_dirs, shared_params):
    """The salt: an adapter request right after the base model served the
    same prompt adopts none of its pages, so its stream equals its cold
    stream and the JAX engine's cold stream (the JAX engine salts text
    with b"" whatever the adapter, so its warm stream adopts the base
    model's K/V)."""
    prompt = list(range(5, 18))               # 13 tokens: three full pages of 4
    kw = dict(page_size=4, pages_per_slot=16, num_pages=65)
    je_cold, te_cold = engines(adapter_dirs, shared_params, **kw)
    want = greedy(je_cold, JSamplingParams, "ad0", prompt=prompt)
    assert greedy(te_cold, SamplingParams, "ad0", prompt=prompt) == want
    _je, te = engines(adapter_dirs, shared_params, **kw)
    greedy(te, SamplingParams, None, prompt=prompt)
    hits0 = te.allocator.hit_tokens_total
    assert greedy(te, SamplingParams, "ad0", prompt=prompt) == want
    assert te.allocator.hit_tokens_total == hits0          # no base page adopted
    greedy(te, SamplingParams, "ad0", prompt=prompt)
    assert te.allocator.hit_tokens_total > hits0           # its own pages are
    assert te._adapter_salt(None) == b"" and te._adapter_salt("ad0") != te._adapter_salt("ad1")


def test_cli_takes_adapters(tmp_path):
    from llms_on_kubernetes_tpu_torch.cli import build_parser, engine_config_from_args

    base = ["serve", "--model", "debug-tiny", "--device", "cpu"]
    cfg = engine_config_from_args(build_parser().parse_args(
        base + ["--adapter", "a=/x", "--adapter", "b=/y", "--adapter-slots", "2",
                "--adapter-rank", "8"]))
    assert cfg.adapters == (("a", "/x"), ("b", "/y"))
    assert (cfg.adapter_slots, cfg.adapter_rank) == (2, 8)
    assert engine_config_from_args(build_parser().parse_args(base)).adapters == ()
    with pytest.raises(SystemExit):
        engine_config_from_args(build_parser().parse_args(base + ["--adapter", "a"]))


# ---------------------------------------------------------------------------
# the server: base:adapter, the 404, /v1/models, the metrics
# ---------------------------------------------------------------------------

def _call(base, path, body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(base + path, data=data,
                                 method="POST" if data is not None else "GET",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_server_adapter_surface(adapter_dirs, shared_params):
    from llms_on_kubernetes_tpu_torch.server import openai_api

    assert openai_api._adapter_from_model("debug-tiny:ad0") == "ad0"
    assert openai_api._adapter_from_model("debug-tiny") is None
    eng = Engine(EngineConfig(**{**ENGINE, "page_size": 4, "pages_per_slot": 32,
                                 "num_pages": 129, "prefill_buckets": (32,)},
                              adapters=adapter_dirs, device="cpu"), params=shared_params[1])
    server = OpenAIServer(eng, ByteTokenizer(), "debug-tiny")
    base = f"http://127.0.0.1:{server.start('127.0.0.1', 0)}"
    try:
        status, body = _call(base, "/v1/models")
        assert status == 200
        assert [m["id"] for m in json.loads(body)["data"]] == [
            "debug-tiny", "debug-tiny:ad0", "debug-tiny:ad1", "debug-tiny:ad2"]
        req = {"prompt": "abc", "max_tokens": 6, "temperature": 0}
        outs = {}
        for model in ("debug-tiny", "debug-tiny:ad0", "debug-tiny:ad1"):
            status, body = _call(base, "/v1/completions", {**req, "model": model})
            doc = json.loads(body)
            assert status == 200 and doc["model"] == model
            outs[model] = doc["choices"][0]["text"]
        status, body = _call(base, "/v1/chat/completions", {
            "model": "debug-tiny:ad1", "messages": [{"role": "user", "content": "x"}],
            "max_tokens": 3, "stream": True})
        chunks = [json.loads(line[6:]) for line in body.decode().splitlines()
                  if line.startswith("data: {")]
        assert status == 200 and chunks and all(c["model"] == "debug-tiny:ad1" for c in chunks)
        status, body = _call(base, "/v1/completions", {**req, "model": "debug-tiny:nope"})
        err = json.loads(body)["error"]
        assert status == 404 and err["code"] == "adapter_not_found"
        status, body = _call(base, "/metrics")
        text = body.decode()

        def value(line_start):
            return sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
                       if line.startswith(line_start))

        assert value("llm_adapter_cache_misses_total") >= 2
        assert value("llm_adapter_load_seconds_count") >= 2
        assert "llm_adapter_cache_hits_total" in text
        assert "llm_adapter_cache_evictions_total" in text
        # the per-request model label separates the tenant models
        assert value('llm_e2e_latency_seconds_count{model="debug-tiny:ad0"}') == 1
        assert value('llm_e2e_latency_seconds_count{model="debug-tiny"}') == 1
    finally:
        server.close()

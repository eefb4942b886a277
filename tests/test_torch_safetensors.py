"""The port's safetensors reader and checkpoint writer against the
``safetensors`` package (installed here, absent on the card's machine).

- The reader (``engine/safetensors.py``: numpy memmap) gives the package's
  tensors bit for bit, every dtype it takes (BF16 through
  ``safetensors.torch``, numpy having no bfloat16), and reads a two-shard
  checkpoint with an index as the JAX loader globs it.
- It refuses a header whose ranges overlap, leave a gap, run past the file
  or do not hold their shape's bytes, and a file cut short.
- The writer's files (``testing/synth_checkpoint.py``) read back through
  the package as what ``tensor_value`` says was written.
"""

import json
import struct

import numpy as np
import pytest
import safetensors.numpy
import safetensors.torch
import torch

from llms_on_kubernetes_tpu_torch.configs import get_config
from llms_on_kubernetes_tpu_torch.engine import safetensors as st
from llms_on_kubernetes_tpu_torch.testing import synth_checkpoint as sc


def _load(path) -> dict:
    f = st.SafetensorsFile(path)
    return {name: f.tensor(name) for name in f.keys()}


NP_DTYPES = [np.float64, np.float32, np.float16, np.int64, np.int32, np.int16, np.int8,
             np.uint8, np.bool_]


def _arrays(rng):
    out = {}
    for i, dt in enumerate(NP_DTYPES):
        shape = [(3, 5), (7,), (2, 3, 4), (), (0, 4), (1, 1), (6, 2), (9,), (4, 4)][i]
        if dt == np.bool_:
            a = rng.random(shape) > 0.5
        elif np.issubdtype(dt, np.integer):
            info = np.iinfo(dt)
            a = rng.integers(max(info.min, -1000), min(info.max, 1000), size=shape, dtype=dt)
        else:
            a = rng.normal(size=shape).astype(dt)
        out[f"t.{np.dtype(dt).name}"] = a
    return out


def test_reader_equals_safetensors_numpy_every_dtype(tmp_path, rng):
    arrays = _arrays(rng)
    path = tmp_path / "a.safetensors"
    safetensors.numpy.save_file(arrays, str(path), metadata={"format": "np"})
    want = safetensors.numpy.load_file(str(path))
    got = _load(path)
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w)
    assert st.SafetensorsFile(path).metadata == {"format": "np"}


def test_reader_equals_safetensors_torch_bf16(tmp_path):
    x = {"w": torch.randn(33, 17).to(torch.bfloat16), "b": torch.randn(5).to(torch.bfloat16),
         "f": torch.randn(4, 4)}
    path = tmp_path / "b.safetensors"
    safetensors.torch.save_file(x, str(path))
    want = safetensors.torch.load_file(str(path))
    got = _load(path)
    for name in x:
        assert got[name].dtype == want[name].dtype
        assert torch.equal(got[name].view(torch.uint8), want[name].view(torch.uint8)), name


def test_two_shards_with_an_index(tmp_path, rng):
    a = {"model.layers.0.w": rng.normal(size=(8, 4)).astype(np.float32)}
    b = {"model.layers.1.w": rng.normal(size=(8, 4)).astype(np.float32),
         "model.norm.weight": np.ones(4, np.float32)}
    safetensors.numpy.save_file(a, str(tmp_path / "model-00001-of-00002.safetensors"))
    safetensors.numpy.save_file(b, str(tmp_path / "model-00002-of-00002.safetensors"))
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps(
        {"weight_map": {**{k: "model-00001-of-00002.safetensors" for k in a},
                        **{k: "model-00002-of-00002.safetensors" for k in b}}}))
    loaders = st.open_dir(tmp_path)
    assert set(loaders) == set(a) | set(b)
    for name, want in {**a, **b}.items():
        np.testing.assert_array_equal(loaders[name]().numpy(), want)
    with pytest.raises(FileNotFoundError):
        st.open_dir(tmp_path / "nothing-here")
    # a name in two files is refused
    safetensors.numpy.save_file(a, str(tmp_path / "extra.safetensors"))
    with pytest.raises(st.SafetensorsError, match="two files"):
        st.open_dir(tmp_path)


def _raw(header: dict, data: bytes, pad: int = 0) -> bytes:
    h = json.dumps(header).encode() + b" " * pad
    return struct.pack("<Q", len(h)) + h + data


GOOD = {"a": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]},
        "b": {"dtype": "I8", "shape": [4], "data_offsets": [8, 12]}}

MALFORMED = {
    "overlap": ({"a": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]},
                 "b": {"dtype": "I8", "shape": [4], "data_offsets": [4, 8]}}, 12, "overlaps"),
    "gap": ({"a": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]},
             "b": {"dtype": "I8", "shape": [4], "data_offsets": [10, 14]}}, 14, "belong to no"),
    "past_the_file": (GOOD, 10, "end at byte"),
    "trailing_bytes": (GOOD, 16, "end at byte"),
    "wrong_size": ({"a": {"dtype": "F32", "shape": [3], "data_offsets": [0, 8]}}, 8, "needs 12"),
    "unknown_dtype": ({"a": {"dtype": "F8_E5M2", "shape": [8], "data_offsets": [0, 8]}}, 8,
                      "dtype"),
    "bad_offsets": ({"a": {"dtype": "U8", "shape": [8], "data_offsets": [8, 0]}}, 8,
                    "data_offsets"),
    "negative_shape": ({"a": {"dtype": "U8", "shape": [-8], "data_offsets": [0, 8]}}, 8,
                       "shape"),
    "missing_key": ({"a": {"dtype": "U8", "shape": [8]}}, 8, "lacks"),
}


@pytest.mark.parametrize("case", list(MALFORMED))
def test_reader_refuses_a_malformed_header(tmp_path, case):
    header, n_data, match = MALFORMED[case]
    path = tmp_path / "bad.safetensors"
    path.write_bytes(_raw(header, bytes(n_data)))
    with pytest.raises(st.SafetensorsError, match=match):
        st.SafetensorsFile(path)


def test_reader_refuses_a_cut_file_and_a_bad_header(tmp_path):
    path = tmp_path / "cut.safetensors"
    path.write_bytes(b"\x05\x00")
    with pytest.raises(st.SafetensorsError, match="shorter"):
        st.SafetensorsFile(path)
    path.write_bytes(struct.pack("<Q", 1000) + b"{}")
    with pytest.raises(st.SafetensorsError, match="runs past"):
        st.SafetensorsFile(path)
    path.write_bytes(_raw({}, b"")[:8] + b"\xff" * (len(_raw({}, b"")) - 8))
    with pytest.raises(st.SafetensorsError, match="JSON"):
        st.SafetensorsFile(path)
    path.write_bytes(struct.pack("<Q", 2) + b"[]")
    with pytest.raises(st.SafetensorsError, match="object"):
        st.SafetensorsFile(path)
    # the good header, padded with spaces as writers align it, reads back
    path.write_bytes(_raw(GOOD, np.arange(2, dtype=np.float32).tobytes() + bytes(4), pad=5))
    assert _load(path)["a"].tolist() == [0.0, 1.0]


@pytest.mark.parametrize("model,dtype", [("debug-tiny", "float32"), ("debug-gemma", "bfloat16"),
                                         ("debug-byte", "float16")])
def test_writer_reads_back_through_safetensors(tmp_path, model, dtype):
    """The writer's shards and index, read by the safetensors package, hold
    what tensor_value says, in the family's names; the port's reader
    agrees; config.json reads back to the registry entry."""
    from llms_on_kubernetes_tpu_torch.configs import from_hf_config

    cfg = get_config(model)
    index = sc.write_checkpoint(cfg, str(tmp_path), dtype=dtype, max_shard_bytes=40_000)
    shards = sorted(set(index["weight_map"].values()))
    assert len(shards) >= 2 and all((tmp_path / s).is_file() for s in shards)
    specs = {name: (shape, kind) for name, shape, kind in sc.tensor_specs(cfg)}
    assert set(index["weight_map"]) == set(specs)
    ours = st.open_dir(tmp_path)
    total = 0
    for shard in shards:
        loaded = safetensors.torch.load_file(str(tmp_path / shard))
        for name, t in loaded.items():
            assert index["weight_map"][name] == shard
            want = sc.tensor_value(cfg, name, *specs[name], dtype=dtype)
            got = t.view(torch.uint16) if t.dtype == torch.bfloat16 else t
            assert np.array_equal(got.numpy(), want), name
            assert torch.equal(ours[name]().view(torch.uint8), t.view(torch.uint8)), name
            total += t.numel() * t.element_size()
    assert total == index["metadata"]["total_size"]
    back = from_hf_config(str(tmp_path / "config.json"), name=cfg.name)
    assert back == cfg


def test_writer_names_phi3_fused_and_gemma_norms():
    phi = {n for n, _, _ in sc.tensor_specs(get_config("phi-3-mini"))}
    assert "model.layers.31.self_attn.qkv_proj.weight" in phi
    assert "model.layers.0.mlp.gate_up_proj.weight" in phi
    assert not any("q_proj" in n or "gate_proj" in n for n in phi)
    shapes = {n: s for n, s, _ in sc.tensor_specs(get_config("phi-3-mini"))}
    assert shapes["model.layers.0.self_attn.qkv_proj.weight"] == (9216, 3072)
    assert shapes["model.layers.0.mlp.gate_up_proj.weight"] == (16384, 3072)
    assert shapes["model.layers.0.mlp.down_proj.weight"] == (3072, 8192)
    assert shapes["lm_head.weight"] == shapes["model.embed_tokens.weight"] == (32064, 3072)
    total = sum(int(np.prod(s)) * 2 for s in shapes.values())
    assert 7.6e9 < total < 7.7e9                 # 3.82 B parameters in bf16
    gemma = {n for n, _, _ in sc.tensor_specs(get_config("gemma-2-9b"))}
    for norm in ("input_layernorm", "post_attention_layernorm", "pre_feedforward_layernorm",
                 "post_feedforward_layernorm"):
        assert f"model.layers.41.{norm}.weight" in gemma
    assert "lm_head.weight" not in gemma         # tied
    # MoE configs are written in Mixtral's naming (Qwen3-MoE's with q/k
    # norms: tests/test_torch_moe.py); a vision tower is not written
    import dataclasses

    from llms_on_kubernetes_tpu_torch.configs import VisionConfig

    assert sc.family(dataclasses.replace(get_config("debug-tiny"), num_experts=4)) == "mixtral"
    with pytest.raises(NotImplementedError):
        sc.family(dataclasses.replace(get_config("debug-tiny"), vision=VisionConfig(
            hidden_size=16, intermediate_size=32, num_layers=1, num_heads=2, image_size=16,
            patch_size=4)))

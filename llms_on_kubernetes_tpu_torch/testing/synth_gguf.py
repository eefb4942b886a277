"""Write synthetic GGUF v3 model files: llama.cpp's container with random,
finite, seeded payloads in any of the seven ggml types ``engine/gguf.py``
reads, and optionally an embedded SentencePiece vocabulary and chat
template, so a ``.gguf`` can be served without downloading one.

    python -m llms_on_kubernetes_tpu_torch.testing.synth_gguf PRESET OUT.gguf [--seed N]
        [--layers L]

``--layers`` cuts a preset's depth (its widths stay the published ones).

Presets, at their published widths (the models' HF ``config.json``):

- ``tinyllama-1.1b``: TinyLlama/TinyLlama-1.1B-Chat-v1.0 (hidden 2,048,
  22 layers, 32/4 heads, FFN 5,632, vocab 32,000), every matrix Q8_0, the
  zephyr chat template;
- ``phi-3-mini``: microsoft/Phi-3-mini-4k-instruct (hidden 3,072, 32
  layers, 32/32 heads of 96, FFN 8,192, vocab 32,064, sliding window
  2,047) in llama.cpp's q4 layout: architecture ``phi3`` with the fused
  ``attn_qkv`` and gate+up ``ffn_up``, Q4_K matrices and a Q6_K output,
  the phi-3 chat template and special tokens;
- ``llama-3.2-1b``: meta-llama/Llama-3.2-1B (hidden 2,048, 16 layers,
  32/8 heads of 64, FFN 8,192, vocab 128,256, tied embeddings, rope theta
  500,000), Q8_0, no tokenizer (a draft model's file).

The vocabulary is the phi-3 family's of ``testing/synth_checkpoint.py``
(BPE merges learned from ``SURVEY.md``, the published special tokens), as
GGUF metadata: the pieces, scores (minus the id: earlier merges win) and
token types (1 normal, 2 unknown, 3 control, 6 byte).

Payloads are drawn per tensor from one ``numpy`` generator seeded with
``seed``: random quant bytes with block scales sized so that a matrix's
values have a standard deviation of about 1/sqrt(fan-in) (norm weights
about 1), so a full-depth forward stays finite in bfloat16.
"""

from __future__ import annotations

import struct
import sys
from typing import Optional

import numpy as np

from llms_on_kubernetes_tpu_torch.engine.gguf import (
    GGML_F16, GGML_F32, GGML_Q4_0, GGML_Q4_1, GGML_Q4_K, GGML_Q6_K, GGML_Q8_0, GGUF_MAGIC,
    _block_layout,
)

ALIGN = 32
# metadata value types (the GGUF spec's)
U32, I32, F32, BOOL, STRING, ARRAY = 4, 5, 6, 7, 8, 9

TINYLLAMA_TEMPLATE = (
    "{% for message in messages %}\n{% if message['role'] == 'user' %}\n"
    "{{ '<|user|>\n' + message['content'] + eos_token }}\n"
    "{% elif message['role'] == 'system' %}\n"
    "{{ '<|system|>\n' + message['content'] + eos_token }}\n"
    "{% elif message['role'] == 'assistant' %}\n"
    "{{ '<|assistant|>\n'  + message['content'] + eos_token }}\n{% endif %}\n"
    "{% if loop.last and add_generation_prompt %}\n{{ '<|assistant|>' }}\n{% endif %}\n"
    "{% endfor %}")

PRESETS = {
    "tinyllama-1.1b": dict(
        name="TinyLlama-1.1B-Chat-v1.0", arch="llama", hidden=2048, layers=22, heads=32,
        kv_heads=4, head_dim=64, ffn=5632, vocab=32000, context=2048, rope_theta=10000.0,
        eps=1e-5, tied=False, fused=False, matrix=GGML_Q8_0, embed=GGML_Q8_0,
        output=GGML_Q8_0, tokenizer="tinyllama"),
    "phi-3-mini": dict(
        name="Phi-3-mini-4k-instruct", arch="phi3", hidden=3072, layers=32, heads=32,
        kv_heads=32, head_dim=96, ffn=8192, vocab=32064, context=4096, rope_theta=10000.0,
        eps=1e-5, tied=False, fused=True, sliding_window=2047, matrix=GGML_Q4_K,
        embed=GGML_Q4_K, output=GGML_Q6_K, tokenizer="phi3"),
    "llama-3.2-1b": dict(
        name="Llama-3.2-1B", arch="llama", hidden=2048, layers=16, heads=32, kv_heads=8,
        head_dim=64, ffn=8192, vocab=128256, context=131072, rope_theta=500000.0, eps=1e-5,
        tied=True, fused=False, matrix=GGML_Q8_0, embed=GGML_Q8_0, output=GGML_Q8_0,
        tokenizer=None),
}


# ---------------------------------------------------------------------------
# payloads
# ---------------------------------------------------------------------------

def _f16(x: np.ndarray) -> np.ndarray:
    return x.astype(np.float16).view(np.uint8).reshape(len(x), 2)


def payload(rng: np.random.Generator, ggml_type: int, n: int, std: float) -> np.ndarray:
    """Random well-formed bytes of a tensor of ``n`` elements whose values
    have a standard deviation of about ``std`` (F32 / F16: normal around
    0, or around 1 for ``std`` < 0, a norm weight)."""
    if ggml_type in (GGML_F32, GGML_F16):
        x = rng.standard_normal(n).astype(np.float32)
        x = 1.0 + 0.05 * x if std < 0 else x * std
        dt = np.float32 if ggml_type == GGML_F32 else np.float16
        return x.astype(dt).view(np.uint8)
    elems, bpb = _block_layout(ggml_type)
    if n % elems:
        raise ValueError(f"{n} elements are not whole blocks of {elems} for type {ggml_type}")
    nb = n // elems
    raw = np.frombuffer(rng.bytes(nb * bpb), np.uint8).reshape(nb, bpb).copy()
    jitter = rng.uniform(0.5, 1.5, nb).astype(np.float32)
    if ggml_type == GGML_Q8_0:          # d * int8, |q| uniform: std ~73
        raw[:, :2] = _f16(jitter * std / 73.0)
    elif ggml_type == GGML_Q4_0:        # d * (nibble - 8): std ~4.6
        raw[:, :2] = _f16(jitter * std / 4.6)
    elif ggml_type == GGML_Q4_1:        # d * nibble + m, centred by m
        d = jitter * std / 4.6
        raw[:, :2] = _f16(d)
        raw[:, 2:4] = _f16(-7.5 * d)
    elif ggml_type == GGML_Q4_K:        # d * sc * nibble - dmin * mn
        d = jitter * std / (31.5 * 4.6)
        raw[:, 0:2] = _f16(d)
        raw[:, 2:4] = _f16(7.5 * d)
    elif ggml_type == GGML_Q6_K:        # d * int8 scale * (q6 - 32)
        raw[:, 192:208] = rng.integers(-64, 64, (nb, 16), dtype=np.int8).view(np.uint8)
        raw[:, 208:210] = _f16(jitter * std / (37.0 * 18.5))
    else:
        raise ValueError(f"ggml type {ggml_type} has no writer")
    return raw.reshape(-1)


# ---------------------------------------------------------------------------
# the container
# ---------------------------------------------------------------------------

def _s(text: str) -> bytes:
    b = text.encode("utf-8")
    return struct.pack("<Q", len(b)) + b


_SCALAR = {U32: "<I", I32: "<i", F32: "<f", BOOL: "<?"}


def _value(vtype: int, value) -> bytes:
    if vtype in _SCALAR:
        return struct.pack(_SCALAR[vtype], value)
    if vtype == STRING:
        return _s(value)
    raise ValueError(f"metadata type {vtype} has no writer")


def _kv(key: str, vtype, value) -> bytes:
    """One metadata entry; ``vtype`` (ARRAY, element type) for an array."""
    if isinstance(vtype, tuple):
        etype = vtype[1]
        out = _s(key) + struct.pack("<IIQ", ARRAY, etype, len(value))
        if etype == STRING:
            return out + b"".join(_s(v) for v in value)
        return out + np.asarray(value, {F32: "<f4", I32: "<i4", U32: "<u4"}[etype]).tobytes()
    return _s(key) + struct.pack("<I", vtype) + _value(vtype, value)


def write_gguf(path: str, metadata: list, tensors: list, seed: int = 0) -> int:
    """Write a GGUF v3 file: ``metadata`` [(key, vtype, value)], then
    ``tensors`` [(name, row-major shape, ggml type, std)], each payload
    drawn in order from one generator seeded with ``seed`` and written as
    it is made (one tensor in memory at a time). Returns the file's bytes."""
    rng = np.random.default_rng(seed)
    head = GGUF_MAGIC + struct.pack("<IQQ", 3, len(tensors), len(metadata))
    kv = b"".join(_kv(k, t, v) for k, t, v in metadata)
    infos, offset, sizes = b"", 0, []
    for name, shape, ggml_type, _std in tensors:
        n = int(np.prod(shape))
        elems, bpb = _block_layout(ggml_type)
        size = n // elems * bpb
        ne = list(reversed(shape))  # fastest-varying first on disk
        infos += _s(name) + struct.pack("<I", len(ne))
        infos += b"".join(struct.pack("<Q", d) for d in ne)
        infos += struct.pack("<IQ", ggml_type, offset)
        sizes.append(size)
        offset += size + (-size) % ALIGN
    blob = head + kv + infos
    with open(path, "wb") as f:
        f.write(blob + b"\x00" * ((-len(blob)) % ALIGN))
        for (_name, shape, ggml_type, std), size in zip(tensors, sizes):
            data = payload(rng, ggml_type, int(np.prod(shape)), std)
            f.write(data.tobytes())
            f.write(b"\x00" * ((-size) % ALIGN))
        return f.tell()


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

def spm_vocab(family: str, size: int) -> dict:
    """The SentencePiece metadata of ``family`` ("tinyllama" or "phi3") at
    ``size`` ids: the phi-3 family's trained pieces, its special tokens for
    "phi3" (``<|end|>`` the end of a turn), ``<unk>`` / ``<s>`` / ``</s>``
    for "tinyllama"."""
    from llms_on_kubernetes_tpu_torch.testing.synth_checkpoint import (
        PHI3_SPECIAL, tokenizer_files,
    )

    vocab = tokenizer_files("phi3")[0]["model"]["vocab"]
    tokens = [t for t, _i in sorted(vocab.items(), key=lambda kv: kv[1])]
    if family == "phi3":
        specials = dict(PHI3_SPECIAL)
        for i in range(len(tokens), size):
            specials.setdefault(i, f"<|placeholder{i - 32000}|>")
        tokens += [specials[i] for i in range(len(tokens), size)]
        eos, add_bos = 32007, False
        from llms_on_kubernetes_tpu_torch.testing.synth_checkpoint import PHI3_CHAT_TEMPLATE
        template = PHI3_CHAT_TEMPLATE
    elif family == "tinyllama":
        specials = {0: "<unk>", 1: "<s>", 2: "</s>"}
        eos, add_bos, template = 2, True, TINYLLAMA_TEMPLATE
    else:
        raise ValueError(f"no SentencePiece vocabulary for {family!r}")
    tokens = tokens[:size]
    types = []
    for i, t in enumerate(tokens):
        if i == 0:
            types.append(2)
        elif i in specials:
            types.append(3)
        elif t.startswith("<0x") and t.endswith(">") and len(t) == 6:
            types.append(6)
        else:
            types.append(1)
    return {"tokens": tokens, "scores": [float(-i) for i in range(len(tokens))],
            "types": types, "bos": 1, "eos": eos, "add_bos": add_bos, "template": template}


def model_metadata(spec: dict) -> list:
    """The architecture keys ``config_from_gguf`` reads, and the tokenizer's."""
    a = spec["arch"]
    md = [("general.architecture", STRING, a), ("general.name", STRING, spec["name"]),
          ("general.alignment", U32, ALIGN),
          (f"{a}.embedding_length", U32, spec["hidden"]),
          (f"{a}.block_count", U32, spec["layers"]),
          (f"{a}.feed_forward_length", U32, spec["ffn"]),
          (f"{a}.attention.head_count", U32, spec["heads"]),
          (f"{a}.attention.head_count_kv", U32, spec["kv_heads"]),
          (f"{a}.attention.key_length", U32, spec["head_dim"]),
          (f"{a}.attention.value_length", U32, spec["head_dim"]),
          (f"{a}.rope.freq_base", F32, spec["rope_theta"]),
          (f"{a}.context_length", U32, spec["context"]),
          (f"{a}.attention.layer_norm_rms_epsilon", F32, spec["eps"])]
    if spec.get("sliding_window"):
        md.append((f"{a}.attention.sliding_window", U32, spec["sliding_window"]))
    if spec.get("tokenizer"):
        v = spm_vocab(spec["tokenizer"], spec["vocab"])
        md += [("tokenizer.ggml.model", STRING, "llama"),
               ("tokenizer.ggml.tokens", (ARRAY, STRING), v["tokens"]),
               ("tokenizer.ggml.scores", (ARRAY, F32), v["scores"]),
               ("tokenizer.ggml.token_type", (ARRAY, I32), v["types"]),
               ("tokenizer.ggml.bos_token_id", U32, v["bos"]),
               ("tokenizer.ggml.eos_token_id", U32, v["eos"]),
               ("tokenizer.ggml.add_bos_token", BOOL, v["add_bos"]),
               ("tokenizer.chat_template", STRING, v["template"])]
    return md


def model_tensors(spec: dict) -> list:
    """(name, shape, ggml type, std) of every tensor, llama.cpp's names:
    phi3 fuses q/k/v into ``attn_qkv`` and gate/up into ``ffn_up``."""
    D, F, V = spec["hidden"], spec["ffn"], spec["vocab"]
    H, KV, hd = spec["heads"], spec["kv_heads"], spec["head_dim"]
    mat, out = spec["matrix"], []
    out.append(("token_embd.weight", (V, D), spec["embed"], 1.0))
    out.append(("output_norm.weight", (D,), GGML_F32, -1.0))
    if not spec["tied"]:
        out.append(("output.weight", (V, D), spec["output"], D ** -0.5))
    for i in range(spec["layers"]):
        p = f"blk.{i}."
        if spec["fused"]:
            out.append((p + "attn_qkv.weight", ((H + 2 * KV) * hd, D), mat, D ** -0.5))
        else:
            out.append((p + "attn_q.weight", (H * hd, D), mat, D ** -0.5))
            out.append((p + "attn_k.weight", (KV * hd, D), mat, D ** -0.5))
            out.append((p + "attn_v.weight", (KV * hd, D), mat, D ** -0.5))
        out.append((p + "attn_output.weight", (D, H * hd), mat, (H * hd) ** -0.5))
        out.append((p + "attn_norm.weight", (D,), GGML_F32, -1.0))
        out.append((p + "ffn_norm.weight", (D,), GGML_F32, -1.0))
        if spec["fused"]:
            out.append((p + "ffn_up.weight", (2 * F, D), mat, D ** -0.5))
        else:
            out.append((p + "ffn_gate.weight", (F, D), mat, D ** -0.5))
            out.append((p + "ffn_up.weight", (F, D), mat, D ** -0.5))
        out.append((p + "ffn_down.weight", (D, F), mat, F ** -0.5))
    return out


def write_model(path: str, spec: dict, seed: int = 0) -> int:
    """Write the model ``spec`` (a ``PRESETS`` entry, or one of the same
    keys at other widths) as a GGUF file. Returns its bytes."""
    return write_gguf(path, model_metadata(spec), model_tensors(spec), seed=seed)


def main(argv: Optional[list] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m llms_on_kubernetes_tpu_torch.testing.synth_gguf")
    ap.add_argument("preset", choices=sorted(PRESETS))
    ap.add_argument("out")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None, help="the preset's own by default")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    spec = dict(PRESETS[args.preset])
    if args.layers is not None:
        spec["layers"] = args.layers
    n = write_model(args.out, spec, seed=args.seed)
    print(f"{args.out}: {n} bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

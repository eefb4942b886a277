"""GGUF checkpoint loading: llama.cpp model files -> the port's parameters
(the port's copy of ``llms_on_kubernetes_tpu/engine/gguf.py``).

The reference's local solution serves GGUF files with ``llama-server
--model <modelPath>`` (TinyLlama Q8_0 and Phi-3-mini q4 as the documented
models). This module gives the port the same input: parse the GGUF
container (v2/v3, memory-mapped), dequantize the ggml-quantized tensors to
numpy float32, and map llama.cpp tensor names into the decoder's
layer-stacked layout.

Implemented ggml dtypes: F32, F16, Q8_0, Q4_0, Q4_1, Q4_K, Q6_K. The
dequantizers do the JAX module's numpy arithmetic, element for element,
so their float32 values are bit-equal to the JAX ``dequantize`` (the K
quants in one pass over a tensor instead of the JAX loops over its
sub-blocks; ``GGUFFile.tensor`` runs a large tensor's blocks on several
threads).
``GGUFFile`` and ``config_from_gguf`` are copies too, ``config_from_gguf``
with what it leaves out (rope scaling, among others: a file that needs it
is served without it, as the JAX package serves it).

``load_gguf_params`` differs from the JAX loader in one way only: it
dequantizes and uploads a tensor at a time into stacks allocated once on
the device, and transposes and splits on the device (the JAX loader stacks
every layer in float32 on the host first), so the host holds one float32
tensor at most. The values are the JAX loader's: each tensor dequantized
to float32, transposed, cast to the serving dtype; with
``quantization="int8"`` the cast weights are quantized by the port's
``ops/quant.quantize`` as the JAX ``quantize_params`` quantizes them.

Format reference: the public GGUF spec (magic "GGUF", little-endian,
metadata KV section, tensor infos, alignment-padded data section) and the
public ggml block formats.
"""

from __future__ import annotations

import mmap
import os
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import Any, BinaryIO, Optional

import numpy as np
import torch

from llms_on_kubernetes_tpu_torch import resolve_device
from llms_on_kubernetes_tpu_torch.configs import ModelConfig

Params = dict[str, Any]

GGUF_MAGIC = b"GGUF"

# metadata value types
_T_U8, _T_I8, _T_U16, _T_I16, _T_U32, _T_I32, _T_F32, _T_BOOL = range(8)
_T_STRING, _T_ARRAY, _T_U64, _T_I64, _T_F64 = range(8, 13)

_SCALAR_FMT = {
    _T_U8: "<B", _T_I8: "<b", _T_U16: "<H", _T_I16: "<h",
    _T_U32: "<I", _T_I32: "<i", _T_F32: "<f", _T_BOOL: "<?",
    _T_U64: "<Q", _T_I64: "<q", _T_F64: "<d",
}

# ggml tensor dtypes (subset)
GGML_F32, GGML_F16 = 0, 1
GGML_Q4_0, GGML_Q4_1 = 2, 3
GGML_Q8_0 = 8
GGML_Q4_K = 12
GGML_Q6_K = 14
GGML_TYPES = (GGML_F32, GGML_F16, GGML_Q4_0, GGML_Q4_1, GGML_Q8_0, GGML_Q4_K, GGML_Q6_K)

_QK = 32       # elements per simple-quant block
_QK_K = 256    # elements per k-quant super-block
# elements a dequantizing thread takes at a time (a multiple of both blocks)
_PIECE = 1 << 20


def _dequant_threads() -> int:
    """Threads a large tensor is dequantized on: the cores this process
    may run on (at most 16)."""
    try:
        return max(1, min(16, len(os.sched_getaffinity(0))))
    except AttributeError:
        return max(1, min(16, os.cpu_count() or 1))


def _block_layout(ggml_type: int) -> tuple[int, int]:
    """(elements per block, bytes per block)."""
    if ggml_type == GGML_F32:
        return 1, 4
    if ggml_type == GGML_F16:
        return 1, 2
    if ggml_type == GGML_Q8_0:
        return _QK, 2 + _QK                       # f16 d + 32 x i8
    if ggml_type == GGML_Q4_0:
        return _QK, 2 + _QK // 2                  # f16 d + 16 bytes nibbles
    if ggml_type == GGML_Q4_1:
        return _QK, 4 + _QK // 2                  # f16 d, f16 m + nibbles
    if ggml_type == GGML_Q4_K:
        return _QK_K, 2 + 2 + 12 + _QK_K // 2     # d, dmin, scales, qs
    if ggml_type == GGML_Q6_K:
        return _QK_K, _QK_K // 2 + _QK_K // 4 + _QK_K // 16 + 2
    raise NotImplementedError(f"ggml tensor type {ggml_type} not supported")


# ---------------------------------------------------------------------------
# Dequantization (vectorized numpy, one call per tensor)
# ---------------------------------------------------------------------------

def _dequant_q8_0(raw: np.ndarray, n: int) -> np.ndarray:
    blocks = raw.reshape(-1, 2 + _QK)
    d = blocks[:, :2].copy().view(np.float16).astype(np.float32)   # [B,1]
    q = blocks[:, 2:].view(np.int8).astype(np.float32)             # [B,32]
    return (d * q).reshape(-1)[:n]


def _dequant_q4_0(raw: np.ndarray, n: int) -> np.ndarray:
    blocks = raw.reshape(-1, 2 + _QK // 2)
    d = blocks[:, :2].copy().view(np.float16).astype(np.float32)
    qs = blocks[:, 2:]
    lo = (qs & 0x0F).astype(np.float32) - 8.0                      # [B,16]
    hi = (qs >> 4).astype(np.float32) - 8.0
    out = np.concatenate([lo, hi], axis=1) * d                     # [B,32]
    return out.reshape(-1)[:n]


def _dequant_q4_1(raw: np.ndarray, n: int) -> np.ndarray:
    blocks = raw.reshape(-1, 4 + _QK // 2)
    d = blocks[:, :2].copy().view(np.float16).astype(np.float32)
    m = blocks[:, 2:4].copy().view(np.float16).astype(np.float32)
    qs = blocks[:, 4:]
    lo = (qs & 0x0F).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    out = np.concatenate([lo, hi], axis=1) * d + m
    return out.reshape(-1)[:n]


def _unpack_qk_scales(scales: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Q4_K packed 6-bit scales/mins: scales[12] bytes -> (sc[8], m[8])."""
    sc = np.empty(scales.shape[:-1] + (8,), np.float32)
    mn = np.empty_like(sc)
    s = scales.astype(np.uint8)
    for j in range(8):
        if j < 4:
            sc[..., j] = (s[..., j] & 63)
            mn[..., j] = (s[..., j + 4] & 63)
        else:
            sc[..., j] = (s[..., j + 4] & 0x0F) | ((s[..., j - 4] >> 6) << 4)
            mn[..., j] = (s[..., j + 4] >> 4) | ((s[..., j] >> 6) << 4)
    return sc, mn


def _dequant_q4_k(raw: np.ndarray, n: int) -> np.ndarray:
    bs = 2 + 2 + 12 + _QK_K // 2
    blocks = raw.reshape(-1, bs)
    B = blocks.shape[0]
    d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32)[:, 0]
    dmin = blocks[:, 2:4].copy().view(np.float16).astype(np.float32)[:, 0]
    sc, mn = _unpack_qk_scales(blocks[:, 4:16])                    # [B,8]
    # 4 chunks of 64 elements; chunk c uses qs[32c:32c+32]: low nibbles are
    # sub-block 2c, high nibbles sub-block 2c+1 (sub-block j's scale
    # d * sc[j], its min dmin * mn[j]); the JAX loop's arithmetic, one pass
    qs = blocks[:, 16:].reshape(B, 4, 32)
    q = np.empty((B, 4, 2, 32), np.float32)
    q[:, :, 0] = qs & 0x0F
    q[:, :, 1] = qs >> 4
    q = q.reshape(B, 8, 32)
    q *= (d[:, None] * sc)[:, :, None]
    q -= (dmin[:, None] * mn)[:, :, None]
    return q.reshape(-1)[:n]


def _dequant_q6_k(raw: np.ndarray, n: int) -> np.ndarray:
    bs = _QK_K // 2 + _QK_K // 4 + _QK_K // 16 + 2
    blocks = raw.reshape(-1, bs)
    B = blocks.shape[0]
    ql = blocks[:, :128].reshape(B, 2, 2, 32)         # [half, low/high 32, 32]
    qh = blocks[:, 128:192].reshape(B, 2, 32)
    scales = blocks[:, 192:208].view(np.int8).astype(np.float32)   # [B,16]
    d = blocks[:, 208:210].copy().view(np.float16).astype(np.float32)[:, 0]
    # two 128-element halves; half h holds four sub-blocks of 32 (q1..q4),
    # each two runs of 16 with scales[8h + 2 sub] and [8h + 2 sub + 1]
    q = np.empty((B, 2, 4, 32), np.uint8)
    q[:, :, 0] = (ql[:, :, 0] & 0x0F) | ((qh & 0x03) << 4)
    q[:, :, 1] = (ql[:, :, 1] & 0x0F) | (((qh >> 2) & 0x03) << 4)
    q[:, :, 2] = (ql[:, :, 0] >> 4) | (((qh >> 4) & 0x03) << 4)
    q[:, :, 3] = (ql[:, :, 1] >> 4) | (((qh >> 6) & 0x03) << 4)
    qq = q.astype(np.float32) - 32.0
    out = (d[:, None] * scales).reshape(B, 2, 4, 2, 1) * qq.reshape(B, 2, 4, 2, 16)
    return out.reshape(-1)[:n]


def dequantize(ggml_type: int, raw: np.ndarray, n_elements: int) -> np.ndarray:
    """raw uint8 buffer for a whole tensor -> float32 [n_elements]."""
    if ggml_type == GGML_F32:
        return raw.view(np.float32)[:n_elements].astype(np.float32)
    if ggml_type == GGML_F16:
        return raw.view(np.float16)[:n_elements].astype(np.float32)
    if ggml_type == GGML_Q8_0:
        return _dequant_q8_0(raw, n_elements)
    if ggml_type == GGML_Q4_0:
        return _dequant_q4_0(raw, n_elements)
    if ggml_type == GGML_Q4_1:
        return _dequant_q4_1(raw, n_elements)
    if ggml_type == GGML_Q4_K:
        return _dequant_q4_k(raw, n_elements)
    if ggml_type == GGML_Q6_K:
        return _dequant_q6_k(raw, n_elements)
    raise NotImplementedError(f"ggml tensor type {ggml_type} not supported")


# ---------------------------------------------------------------------------
# Container parsing
# ---------------------------------------------------------------------------

class GGUFFile:
    """Parsed GGUF container: metadata dict + lazy mmap tensor access."""

    def __init__(self, path: str):
        self.path = str(path)
        self.metadata: dict[str, Any] = {}
        # name -> (shape tuple (row-major, out-first), ggml_type, offset, n)
        self.tensors: dict[str, tuple[tuple[int, ...], int, int, int]] = {}
        self._file: Optional[BinaryIO] = open(self.path, "rb")
        self._parse(self._file)
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)

    # -- reading helpers -------------------------------------------------
    @staticmethod
    def _read(f: BinaryIO, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, f.read(size))[0]

    def _read_string(self, f: BinaryIO) -> str:
        n = self._read(f, "<Q")
        return f.read(n).decode("utf-8", errors="replace")

    def _read_value(self, f: BinaryIO, vtype: int):
        if vtype in _SCALAR_FMT:
            return self._read(f, _SCALAR_FMT[vtype])
        if vtype == _T_STRING:
            return self._read_string(f)
        if vtype == _T_ARRAY:
            etype = self._read(f, "<I")
            count = self._read(f, "<Q")
            return [self._read_value(f, etype) for _ in range(count)]
        raise ValueError(f"bad GGUF metadata value type {vtype}")

    def _parse(self, f: BinaryIO) -> None:
        if f.read(4) != GGUF_MAGIC:
            raise ValueError(f"{self.path}: not a GGUF file")
        version = self._read(f, "<I")
        if version < 2:
            raise ValueError(f"GGUF v{version} unsupported (need v2+)")
        n_tensors = self._read(f, "<Q")
        n_kv = self._read(f, "<Q")
        for _ in range(n_kv):
            key = self._read_string(f)
            vtype = self._read(f, "<I")
            self.metadata[key] = self._read_value(f, vtype)

        infos = []
        for _ in range(n_tensors):
            name = self._read_string(f)
            n_dims = self._read(f, "<I")
            # GGUF stores ne[] fastest-varying first; reverse for row-major
            ne = [self._read(f, "<Q") for _ in range(n_dims)]
            ggml_type = self._read(f, "<I")
            offset = self._read(f, "<Q")
            infos.append((name, tuple(reversed(ne)), ggml_type, offset))

        alignment = int(self.metadata.get("general.alignment", 32))
        data_start = f.tell()
        data_start += (-data_start) % alignment
        self._data_start = data_start
        for name, shape, ggml_type, offset in infos:
            n = int(np.prod(shape)) if shape else 1
            self.tensors[name] = (shape, ggml_type, data_start + offset, n)

    # -- tensor access ---------------------------------------------------
    def tensor(self, name: str) -> np.ndarray:
        """Dequantized float32 tensor in row-major [out, in] orientation.
        A large quantized tensor is dequantized in whole-block pieces on
        ``_dequant_threads()`` threads (numpy releases the interpreter
        lock in its loops); each element takes the same operations as in
        one call, so the values are the same bits."""
        shape, ggml_type, offset, n = self.tensors[name]
        elems, bpb = _block_layout(ggml_type)
        nbytes = (n // elems) * bpb
        raw = np.frombuffer(self._mm, np.uint8, count=nbytes, offset=offset)
        threads = _dequant_threads()
        if elems == 1 or n < _PIECE * 2 or threads <= 1:
            return dequantize(ggml_type, raw, n).reshape(shape)
        out = np.empty(n, np.float32)
        step = _PIECE // elems                      # blocks a piece
        nb = n // elems

        def piece(b0: int) -> None:
            b1 = min(nb, b0 + step)
            out[b0 * elems:b1 * elems] = dequantize(
                ggml_type, raw[b0 * bpb:b1 * bpb], (b1 - b0) * elems)

        with ThreadPoolExecutor(threads) as ex:
            list(ex.map(piece, range(0, nb, step)))
        return out.reshape(shape)

    def close(self) -> None:
        if self._file is not None:
            self._mm.close()
            self._file.close()
            self._file = None


# ---------------------------------------------------------------------------
# Metadata -> ModelConfig
# ---------------------------------------------------------------------------

def config_from_gguf(gf: GGUFFile, name: Optional[str] = None) -> ModelConfig:
    md = gf.metadata
    arch = md.get("general.architecture", "llama")
    g = lambda k, default=None: md.get(f"{arch}.{k}", default)  # noqa: E731

    D = int(g("embedding_length"))
    H = int(g("attention.head_count"))
    KV = int(g("attention.head_count_kv", H))
    hd = int(g("attention.key_length", D // H))
    vocab = gf.tensors["token_embd.weight"][0][0]
    return ModelConfig(
        name=name or md.get("general.name", arch),
        vocab_size=int(vocab),
        hidden_size=D,
        intermediate_size=int(g("feed_forward_length")),
        num_layers=int(g("block_count")),
        num_heads=H,
        num_kv_heads=KV,
        head_dim=hd,
        rope_theta=float(g("rope.freq_base", 10000.0)),
        rms_norm_eps=float(g("attention.layer_norm_rms_epsilon", 1e-5)),
        max_position_embeddings=int(g("context_length", 4096)),
        tie_word_embeddings="output.weight" not in gf.tensors,
        sliding_window=(int(g("attention.sliding_window"))
                        if g("attention.sliding_window") else None),
    )


# ---------------------------------------------------------------------------
# Tensor-name mapping -> the decoder's parameters
# ---------------------------------------------------------------------------

def gguf_layer(gf: GGUFFile, cfg: ModelConfig, i: int) -> dict[str, np.ndarray]:
    """Layer ``i``'s parameters as float32 numpy in the decoder's layout
    (the JAX loader's per-layer dict): llama names, or phi3's fused
    ``attn_qkv`` and fused gate+up ``ffn_up``. GGUF stores linears [out,
    in] (after the ne reversal), as HF does, so they are transposed."""
    H, KV, hd, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.hidden_size

    def lin(name: str, out_reshape=None) -> np.ndarray:
        w = gf.tensor(name).T  # [in, out]
        if out_reshape is not None:
            w = w.reshape(w.shape[0], *out_reshape)
        return w

    p = f"blk.{i}."
    lp: dict[str, np.ndarray] = {}
    if p + "attn_q.weight" in gf.tensors:
        lp["wq"] = lin(p + "attn_q.weight", (H, hd))
        lp["wk"] = lin(p + "attn_k.weight", (KV, hd))
        lp["wv"] = lin(p + "attn_v.weight", (KV, hd))
    else:  # fused qkv (phi3-style exports)
        qkv = gf.tensor(p + "attn_qkv.weight")  # [(H+2KV)*hd, D]
        q, k, v = np.split(qkv, [H * hd, (H + KV) * hd], axis=0)
        lp["wq"] = q.T.reshape(D, H, hd)
        lp["wk"] = k.T.reshape(D, KV, hd)
        lp["wv"] = v.T.reshape(D, KV, hd)
    lp["wo"] = gf.tensor(p + "attn_output.weight").T.reshape(H, hd, D)
    lp["attn_norm"] = gf.tensor(p + "attn_norm.weight")
    lp["mlp_norm"] = gf.tensor(p + "ffn_norm.weight")
    if p + "ffn_gate.weight" in gf.tensors:
        lp["w_gate"] = lin(p + "ffn_gate.weight")
        lp["w_up"] = lin(p + "ffn_up.weight")
    else:  # fused gate+up (phi3-style)
        gu = gf.tensor(p + "ffn_up.weight")
        g_, u_ = np.split(gu, 2, axis=0)
        lp["w_gate"] = g_.T
        lp["w_up"] = u_.T
    lp["w_down"] = lin(p + "ffn_down.weight")
    return lp


def _device_layer(gf: GGUFFile, cfg: ModelConfig, i: int, put) -> dict[str, torch.Tensor]:
    """``gguf_layer`` on the device: each tensor goes there as stored
    (float32 [out, in], ``put``) and is transposed, split and reshaped
    there (exact moves, so the values are ``gguf_layer``'s); the results
    may be strided views."""
    H, KV, hd, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.hidden_size

    def lin(name: str, out_reshape=None) -> torch.Tensor:
        w = put(gf.tensor(name)).T
        return w if out_reshape is None else w.reshape(w.shape[0], *out_reshape)

    p = f"blk.{i}."
    lp: dict[str, torch.Tensor] = {}
    if p + "attn_q.weight" in gf.tensors:
        lp["wq"] = lin(p + "attn_q.weight", (H, hd))
        lp["wk"] = lin(p + "attn_k.weight", (KV, hd))
        lp["wv"] = lin(p + "attn_v.weight", (KV, hd))
    else:  # fused qkv (phi3-style exports)
        q, k, v = torch.split(put(gf.tensor(p + "attn_qkv.weight")),
                              [H * hd, KV * hd, KV * hd], dim=0)
        lp["wq"] = q.T.reshape(D, H, hd)
        lp["wk"] = k.T.reshape(D, KV, hd)
        lp["wv"] = v.T.reshape(D, KV, hd)
    lp["wo"] = put(gf.tensor(p + "attn_output.weight")).T.reshape(H, hd, D)
    lp["attn_norm"] = put(gf.tensor(p + "attn_norm.weight"))
    lp["mlp_norm"] = put(gf.tensor(p + "ffn_norm.weight"))
    if p + "ffn_gate.weight" in gf.tensors:
        lp["w_gate"] = lin(p + "ffn_gate.weight")
        lp["w_up"] = lin(p + "ffn_up.weight")
    else:  # fused gate+up (phi3-style)
        g_, u_ = torch.chunk(put(gf.tensor(p + "ffn_up.weight")), 2, dim=0)
        lp["w_gate"] = g_.T
        lp["w_up"] = u_.T
    lp["w_down"] = lin(p + "ffn_down.weight")
    return lp


def load_gguf_params(
    path: "str | GGUFFile",
    cfg: Optional[ModelConfig] = None,
    dtype: Optional[str] = None,
    quantization: Optional[str] = None,
    device="cuda",
):
    """Load a .gguf file -> (ModelConfig, params) in the decoder's layout on
    ``device``, cast to ``dtype`` (default ``cfg.dtype``).

    Each stacked ``[L, ...]`` tensor is allocated once on the device and
    filled a layer at a time: each of the layer's tensors is dequantized to
    float32 on the host, sent to the device as stored, transposed and split
    there (``_device_layer``), cast and copied into its slot.
    ``quantization="int8"`` quantizes each cast matmul weight
    (``ops/quant.quantize``, the layer's slice of the JAX
    ``quantize_params``); the embedding, the norms and the head stay in
    ``dtype``. Closes the file."""
    from llms_on_kubernetes_tpu_torch.engine.cache import torch_dtype
    from llms_on_kubernetes_tpu_torch.ops.quant import (
        _LAYER_REDUCE_AXES, SUPPORTED_QUANTIZATIONS, QTensor, quantize, reduce_axes_for,
    )

    if quantization not in SUPPORTED_QUANTIZATIONS:
        raise ValueError(f"unknown quantization {quantization!r}")
    if quantization in ("fp8", "awq"):
        raise ValueError(f"quantization={quantization!r} names a safetensors checkpoint "
                         f"format; a GGUF file is dequantized (None) or served int8")
    gf = path if isinstance(path, GGUFFile) else GGUFFile(path)
    cfg = cfg or config_from_gguf(gf)
    dev = resolve_device(device)
    dt = torch_dtype(dtype or cfg.dtype)
    L = cfg.num_layers

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(dev)

    layers: Params = {}
    for i in range(L):
        for name, w in _device_layer(gf, cfg, i, put).items():
            if quantization == "int8" and name in _LAYER_REDUCE_AXES:
                axes = tuple(ax - 1 for ax in reduce_axes_for(name, w.dim() + 1))
                q = quantize(w.to(dt), axes)
                if name not in layers:
                    layers[name] = QTensor(
                        torch.empty((L, *q.data.shape), dtype=torch.int8, device=dev),
                        torch.empty((L, *q.scale.shape), dtype=torch.float32, device=dev))
                layers[name].data[i].copy_(q.data)
                layers[name].scale[i].copy_(q.scale)
                continue
            if name not in layers:     # allocated once, filled a layer at a time
                layers[name] = torch.empty((L, *w.shape), dtype=dt, device=dev)
            layers[name][i].copy_(w)
    params: Params = {
        "embed": put(gf.tensor("token_embd.weight")).to(dt, copy=True),
        "final_norm": put(gf.tensor("output_norm.weight")).to(dt, copy=True),
        "layers": layers,
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = put(gf.tensor("output.weight")).to(dt).T.contiguous()
    gf.close()
    return cfg, params

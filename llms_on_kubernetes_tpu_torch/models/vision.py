"""Vision towers and multimodal projectors (counterpart of
``llms_on_kubernetes_tpu/models/vision.py``).

Two families, as in the JAX package, over its parameter trees (the keys
and layouts of its ``init_vision_params`` / ``init_qwen3vl_vision_params``
and loaders, so weights carry over one to one):

- SigLIP (gemma-3): patch embedding as a product over unfolded patches,
  learned positions, pre-LN blocks (biased attention, GELU-tanh MLP), the
  post-LN, then gemma-3's projector: an average pool to
  ``mm_tokens_per_image`` soft tokens, the zero-centred RMSNorm
  (``x * (1 + w)``) and ``mm_proj`` into the text width.
- Qwen3-VL: the conv3d patch embedding over a duplicated frame as one
  product over flattened patches in the block-merge token order, the
  learned position grid interpolated bilinearly to the image's patch
  grid, pre-LN blocks with 2D rotary attention, the spatial-merge merger
  and the DeepStack mergers, which tap the outputs of the layers
  ``deepstack_indexes`` (the decoder adds them to its first layers'
  outputs at image positions). A video (``encode_video_qwen3vl``) fills
  the conv3d's temporal patch with consecutive frames, and each temporal
  patch is one attention span, as each image is.

The towers run no kernel of their own: projections are ``torch.matmul``,
attention is the JAX einsums (QK^T in float32, softmax, PV), which the JAX
package leaves to XLA. The compute dtype is what JAX's promotion gives:
float32 pixels against bfloat16 weights compute in float32, so each weight
is cast to the pixels' dtype as it is used. Like the decoder, the towers
are functions over a parameter tree; ``vision_encode`` runs the one a
config names.

``load_vision_params`` / ``load_qwen3vl_vision_params`` read the HF tensor
names (``vision_tower.vision_model.*`` and
``multi_modal_projector.*``; ``model.visual.*``) through the checkpoint
loader's ``_Fetch`` (which resolves the ``model.``-prefixed naming of
newer checkpoints). ``qwen_mrope_positions`` is the JAX function, a copy
in pure Python and numpy.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from llms_on_kubernetes_tpu_torch import resolve_device
from llms_on_kubernetes_tpu_torch.configs import VisionConfig
from llms_on_kubernetes_tpu_torch.engine.cache import torch_dtype

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# Init (the JAX shapes and scales, drawn from a torch.Generator)
# ---------------------------------------------------------------------------

def _initializer(gen, dev, dt):
    def init(*shape, scale=0.02):
        out = torch.empty(shape, dtype=dt, device=dev)
        for part in (out if len(shape) > 2 else [out]):
            part.copy_(torch.randn(part.shape, generator=gen, device=dev,
                                   dtype=torch.float32).mul_(scale))
        return out

    def const(value, *shape):
        return torch.full(shape, value, dtype=dt, device=dev)
    return init, const


def init_vision_params(vcfg: VisionConfig, text_hidden: int, gen: torch.Generator,
                       device="cuda", dtype="float32") -> Params:
    """Random SigLIP tower and gemma-3 projector (layer-stacked)."""
    dev, dt = resolve_device(device), torch_dtype(dtype)
    init, const = _initializer(gen, dev, dt)
    D, I, L = vcfg.hidden_size, vcfg.intermediate_size, vcfg.num_layers
    P, C = vcfg.patch_size, vcfg.num_channels
    return {
        "patch_w": init(P, P, C, D), "patch_b": const(0, D),
        "pos_emb": init(vcfg.num_patches, D),
        "layers": {
            "ln1_w": const(1, L, D), "ln1_b": const(0, L, D),
            "wq": init(L, D, D), "bq": const(0, L, D),
            "wk": init(L, D, D), "bk": const(0, L, D),
            "wv": init(L, D, D), "bv": const(0, L, D),
            "wo": init(L, D, D), "bo": const(0, L, D),
            "ln2_w": const(1, L, D), "ln2_b": const(0, L, D),
            "fc1_w": init(L, D, I), "fc1_b": const(0, L, I),
            "fc2_w": init(L, I, D), "fc2_b": const(0, L, D),
        },
        "post_ln_w": const(1, D), "post_ln_b": const(0, D),
        "mm_norm": const(0, D),                   # gemma RMSNorm: x * (1 + w)
        "mm_proj": init(D, text_hidden),
    }


def init_qwen3vl_vision_params(vcfg: VisionConfig, gen: torch.Generator, device="cuda",
                               dtype="float32") -> Params:
    """Random Qwen3-VL tower, merger and DeepStack mergers."""
    dev, dt = resolve_device(device), torch_dtype(dtype)
    init, const = _initializer(gen, dev, dt)
    D, I, L = vcfg.hidden_size, vcfg.intermediate_size, vcfg.num_layers
    feat = vcfg.num_channels * vcfg.temporal_patch_size * vcfg.patch_size ** 2
    m2, out = vcfg.spatial_merge_size ** 2, vcfg.out_hidden_size

    def merger(postshuffle):
        norm_dim = m2 * D if postshuffle else D
        return {"norm_w": const(1, norm_dim), "norm_b": const(0, norm_dim),
                "fc1_w": init(m2 * D, m2 * D), "fc1_b": const(0, m2 * D),
                "fc2_w": init(m2 * D, out), "fc2_b": const(0, out)}

    return {
        "patch_w": init(feat, D), "patch_b": const(0, D),
        "pos_emb": init(vcfg.num_grid_per_side ** 2, D),
        "layers": {
            "ln1_w": const(1, L, D), "ln1_b": const(0, L, D),
            "qkv_w": init(L, D, 3 * D), "qkv_b": const(0, L, 3 * D),
            "proj_w": init(L, D, D), "proj_b": const(0, L, D),
            "ln2_w": const(1, L, D), "ln2_b": const(0, L, D),
            "fc1_w": init(L, D, I), "fc1_b": const(0, L, I),
            "fc2_w": init(L, I, D), "fc2_b": const(0, L, D),
        },
        "merger": merger(False),
        "deepstack": [merger(True) for _ in vcfg.deepstack_indexes],
    }


# ---------------------------------------------------------------------------
# SigLIP (gemma-3)
# ---------------------------------------------------------------------------

def _layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """The JAX ``_layer_norm``: statistics in float32, normalised value
    rounded to x's dtype, then ``* w + b``."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype) + b.to(x.dtype)


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, w.to(x.dtype))


def _compute_dtype(pixels: torch.Tensor, params: Params) -> torch.dtype:
    return torch.promote_types(pixels.dtype, params["patch_w"].dtype)


def encode_images(params: Params, vcfg: VisionConfig, pixels: torch.Tensor) -> torch.Tensor:
    """SigLIP encode and gemma-3 projection: pixels [N, H, W, C]
    (normalised) -> soft tokens [N, mm_tokens_per_image, text_hidden]."""
    dt = _compute_dtype(pixels, params)
    x = pixels.to(dt)
    N, D = x.shape[0], vcfg.hidden_size
    P, S, eps = vcfg.patch_size, vcfg.patches_per_side, vcfg.layer_norm_eps
    # the patch conv as a product over unfolded patches: [N,S,P,S,P,C] x [P,P,C,D]
    x = x.reshape(N, S, P, S, P, vcfg.num_channels).permute(0, 1, 3, 2, 4, 5)
    x = _mm(x.reshape(N, S * S, -1), params["patch_w"].reshape(-1, D))
    x = x + params["patch_b"].to(dt)
    x = x + params["pos_emb"].to(dt)[None]
    nh, hd = vcfg.num_heads, vcfg.head_dim
    scale = hd ** -0.5
    layers = params["layers"]
    for i in range(vcfg.num_layers):
        lp = {k: v[i] for k, v in layers.items()}
        h = _layer_norm(x, lp["ln1_w"], lp["ln1_b"], eps)
        q = (_mm(h, lp["wq"]) + lp["bq"].to(dt)).reshape(N, -1, nh, hd)
        k = (_mm(h, lp["wk"]) + lp["bk"].to(dt)).reshape(N, -1, nh, hd)
        v = (_mm(h, lp["wv"]) + lp["bv"].to(dt)).reshape(N, -1, nh, hd)
        logits = torch.einsum("nqhd,nkhd->nhqk", q, k).float() * scale
        probs = torch.softmax(logits, dim=-1).to(dt)
        attn = torch.einsum("nhqk,nkhd->nqhd", probs, v).reshape(N, -1, D)
        x = x + (_mm(attn, lp["wo"]) + lp["bo"].to(dt))
        h = _layer_norm(x, lp["ln2_w"], lp["ln2_b"], eps)
        h = F.gelu(_mm(h, lp["fc1_w"]) + lp["fc1_b"].to(dt), approximate="tanh")
        x = x + (_mm(h, lp["fc2_w"]) + lp["fc2_b"].to(dt))
    x = _layer_norm(x, params["post_ln_w"], params["post_ln_b"], eps)
    # gemma-3's projector: average pool to t_side^2 soft tokens
    t_side = int(vcfg.mm_tokens_per_image ** 0.5)
    kernel = S // t_side
    x = x.reshape(N, t_side, kernel, t_side, kernel, D).mean(dim=(2, 4))
    x = x.reshape(N, t_side * t_side, D)
    xf = x.float()
    xf = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    x = (xf * (1.0 + params["mm_norm"].float())).to(dt)
    return _mm(x, params["mm_proj"])


# ---------------------------------------------------------------------------
# Qwen3-VL
# ---------------------------------------------------------------------------

def _qwen_patchify(pixels: torch.Tensor, vcfg: VisionConfig) -> torch.Tensor:
    """pixels [N, H, W, C] -> patch features [N, T, C * tp * p * p] in the
    block-merge token order (hb, wb, i, j), each patch's features ordered
    (channel, temporal, ph, pw), the one frame repeated over the temporal
    patch (the Qwen image processor's layout)."""
    N, H, W, C = pixels.shape
    p, m = vcfg.patch_size, vcfg.spatial_merge_size
    sh, sw = H // p, W // p
    x = pixels.permute(0, 3, 1, 2)                        # [N, C, H, W]
    x = x.reshape(N, C, sh // m, m, p, sw // m, m, p)
    x = x.permute(0, 2, 5, 3, 6, 1, 4, 7)                 # [N, hb, wb, i, j, C, p, p]
    x = x.reshape(N, sh * sw, C, 1, p, p)
    x = x.expand(N, sh * sw, C, vcfg.temporal_patch_size, p, p)
    return x.reshape(N, sh * sw, -1)


def _qwen_pos_embed(params: Params, vcfg: VisionConfig, sh: int, sw: int) -> torch.Tensor:
    """The learned [g * g, D] grid bilinearly interpolated to an sh x sw
    patch grid, in block-merge order, float32 (JAX's promotion of the
    table against float32 weights)."""
    m, g = vcfg.spatial_merge_size, vcfg.num_grid_per_side
    idx_h, idx_w = np.linspace(0, g - 1, sh), np.linspace(0, g - 1, sw)
    lo_h, lo_w = idx_h.astype(np.int32), idx_w.astype(np.int32)
    hi_h, hi_w = np.clip(lo_h + 1, None, g - 1), np.clip(lo_w + 1, None, g - 1)
    fr_h = (idx_h - lo_h).astype(np.float32)
    fr_w = (idx_w - lo_w).astype(np.float32)
    pe = params["pos_emb"]
    dev = pe.device

    def gather(hh, ww):
        ids = (hh[:, None] * g + ww[None, :]).reshape(-1)
        return pe[torch.from_numpy(ids.astype(np.int64)).to(dev)].float()

    def weight(a, b):
        return torch.from_numpy((a[:, None] * b[None, :]).reshape(-1, 1)).to(dev)

    pos = (gather(lo_h, lo_w) * weight(1 - fr_h, 1 - fr_w)
           + gather(lo_h, hi_w) * weight(1 - fr_h, fr_w)
           + gather(hi_h, lo_w) * weight(fr_h, 1 - fr_w)
           + gather(hi_h, hi_w) * weight(fr_h, fr_w))
    D = pos.shape[-1]
    pos = pos.reshape(sh // m, m, sw // m, m, D).permute(0, 2, 1, 3, 4)
    return pos.reshape(sh * sw, D)


def _qwen_rope_cos_sin(vcfg: VisionConfig, head_dim: int, sh: int, sw: int):
    """2D rotary tables [T, head_dim] in block-merge order, computed in
    numpy as the JAX function computes them, as float32."""
    m = vcfg.spatial_merge_size
    dim = head_dim // 4
    inv = 1.0 / (10000.0 ** (np.arange(0, dim, dtype=np.float32) / dim))
    row = (np.arange(sh // m)[:, None, None, None] * m + np.arange(m)[None, None, :, None])
    col = (np.arange(sw // m)[None, :, None, None] * m + np.arange(m)[None, None, None, :])
    row = np.broadcast_to(row, (sh // m, sw // m, m, m)).reshape(-1)
    col = np.broadcast_to(col, (sh // m, sw // m, m, m)).reshape(-1)
    freqs = np.concatenate([row[:, None] * inv[None, :], col[:, None] * inv[None, :]], axis=1)
    emb = np.concatenate([freqs, freqs], axis=1)
    return (torch.from_numpy(np.cos(emb).astype(np.float32)),
            torch.from_numpy(np.sin(emb).astype(np.float32)))


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    a, b = x.chunk(2, dim=-1)
    return torch.cat([-b, a], dim=-1)


def _qwen_merger(x: torch.Tensor, mp: Params, m2: int, eps: float,
                 postshuffle: bool) -> torch.Tensor:
    """Spatial merge of m^2 consecutive (block-ordered) tokens: the main
    merger norms each token before the merge, a DeepStack merger the
    merged vector."""
    N, T, D = x.shape
    if postshuffle:
        x = _layer_norm(x.reshape(N, T // m2, m2 * D), mp["norm_w"], mp["norm_b"], eps)
    else:
        x = _layer_norm(x, mp["norm_w"], mp["norm_b"], eps).reshape(N, T // m2, m2 * D)
    h = F.gelu(_mm(x, mp["fc1_w"]) + mp["fc1_b"].to(x.dtype))     # erf, nn.GELU()'s
    return _mm(h, mp["fc2_w"]) + mp["fc2_b"].to(x.dtype)


def encode_images_qwen3vl(params: Params, vcfg: VisionConfig, pixels: torch.Tensor):
    """Qwen3-VL encode: pixels [N, H, W, C] (normalised) -> (soft tokens
    [N, T_merged, out_hidden], DeepStack [n_taps, N, T_merged, out_hidden]
    or None)."""
    _N, H, W, _C = pixels.shape
    sh, sw = H // vcfg.patch_size, W // vcfg.patch_size
    dt = _compute_dtype(pixels, params)
    return _qwen_encode_patches(params, vcfg, _qwen_patchify(pixels.to(dt), vcfg), sh, sw)


def _qwen_encode_patches(params: Params, vcfg: VisionConfig, feats: torch.Tensor,
                         sh: int, sw: int):
    N, dt = feats.shape[0], feats.dtype
    D, nh = vcfg.hidden_size, vcfg.num_heads
    hd, eps, m2 = D // nh, 1e-6, vcfg.spatial_merge_size ** 2
    x = _mm(feats, params["patch_w"]) + params["patch_b"].to(dt)
    x = x + _qwen_pos_embed(params, vcfg, sh, sw)[None].to(dt)
    cos, sin = _qwen_rope_cos_sin(vcfg, hd, sh, sw)
    cos = cos.to(x.device)[None, :, None, :]
    sin = sin.to(x.device)[None, :, None, :]
    scale = hd ** -0.5
    taps = {}
    layers = params["layers"]
    for i in range(vcfg.num_layers):
        lp = {k: v[i] for k, v in layers.items()}
        h = _layer_norm(x, lp["ln1_w"], lp["ln1_b"], eps)
        q, k, v = (_mm(h, lp["qkv_w"]) + lp["qkv_b"].to(dt)).chunk(3, dim=-1)
        q = q.reshape(N, -1, nh, hd).float()
        k = k.reshape(N, -1, nh, hd).float()
        v = v.reshape(N, -1, nh, hd)
        q = q * cos + _rotate_half(q) * sin
        k = k * cos + _rotate_half(k) * sin
        logits = torch.einsum("nqhd,nkhd->nhqk", q, k) * scale
        probs = torch.softmax(logits, dim=-1).to(dt)
        attn = torch.einsum("nhqk,nkhd->nqhd", probs, v).reshape(N, -1, D)
        x = x + (_mm(attn, lp["proj_w"]) + lp["proj_b"].to(dt))
        h = _layer_norm(x, lp["ln2_w"], lp["ln2_b"], eps)
        h = F.gelu(_mm(h, lp["fc1_w"]) + lp["fc1_b"].to(dt), approximate="tanh")
        x = x + (_mm(h, lp["fc2_w"]) + lp["fc2_b"].to(dt))
        if i in vcfg.deepstack_indexes:
            taps[i] = x
    soft = _qwen_merger(x, params["merger"], m2, eps, postshuffle=False)
    if not vcfg.deepstack_indexes:
        return soft, None
    deep = torch.stack([_qwen_merger(taps[t], mp, m2, eps, postshuffle=True)
                        for t, mp in zip(vcfg.deepstack_indexes, params["deepstack"])])
    return soft, deep


def _qwen_patchify_video(frames: torch.Tensor, vcfg: VisionConfig) -> torch.Tensor:
    """frames [F, H, W, C] (F a multiple of temporal_patch_size) -> patch
    features [F / tp, sh * sw, C * tp * p * p]: the Qwen processor's video
    layout, consecutive frames filling the temporal patch (an image
    repeats one frame there), each temporal patch's tokens in block-merge
    order with per-patch features (channel, temporal, ph, pw)."""
    F, H, W, C = frames.shape
    p, m, tp = vcfg.patch_size, vcfg.spatial_merge_size, vcfg.temporal_patch_size
    sh, sw = H // p, W // p
    x = frames.reshape(F // tp, tp, H, W, C).permute(0, 4, 1, 2, 3)     # [T', C, tp, H, W]
    x = x.reshape(F // tp, C, tp, sh // m, m, p, sw // m, m, p)
    x = x.permute(0, 3, 6, 4, 7, 1, 2, 5, 8)                           # [T', hb, wb, i, j, C, tp, p, p]
    return x.reshape(F // tp, sh * sw, C * tp * p * p)


def encode_video_qwen3vl(params: Params, vcfg: VisionConfig, frames: torch.Tensor):
    """Qwen3-VL video encode (the JAX ``encode_video_qwen3vl``): frames
    [F, H, W, C] (normalised, F a multiple of temporal_patch_size) -> (soft
    tokens [F / tp, t_img, out_hidden], DeepStack [n_taps, F / tp, t_img,
    out_hidden] or None). Each temporal patch is its own attention span."""
    _F, H, W, _C = frames.shape
    sh, sw = H // vcfg.patch_size, W // vcfg.patch_size
    dt = _compute_dtype(frames, params)
    return _qwen_encode_patches(params, vcfg, _qwen_patchify_video(frames.to(dt), vcfg), sh, sw)


def vision_encode(params: Params, vcfg: VisionConfig, pixels: torch.Tensor,
                  video: bool = False) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The family's tower on pixels [N, H, W, 3], or with ``video`` on one
    Qwen3-VL video's frames [F, H, W, 3]: (soft tokens [N, t_img, D],
    DeepStack [n_taps, N, t_img, D] or None; N a video's temporal
    patches)."""
    if video:
        if vcfg.family != "qwen3vl":
            raise ValueError("only Qwen3-VL's tower encodes video")
        return encode_video_qwen3vl(params, vcfg, pixels)
    if vcfg.family == "qwen3vl":
        return encode_images_qwen3vl(params, vcfg, pixels)
    return encode_images(params, vcfg, pixels), None


# ---------------------------------------------------------------------------
# HF checkpoints
# ---------------------------------------------------------------------------

def _stack_layers(get, L: int, names: dict) -> Params:
    """{ours: [L, ...]} from {ours: (HF name under the layer prefix, transpose)}."""
    out = {}
    for key, (hf, transpose) in names.items():
        ts = [get(hf(i)) for i in range(L)]
        out[key] = torch.stack([t.T if transpose else t for t in ts])
    return out


def load_vision_params(vcfg: VisionConfig, fetch, dtype="float32") -> Params:
    """HF ``vision_tower.vision_model.*`` and ``multi_modal_projector.*``
    (SiglipVisionModel, Gemma3MultiModalProjector) into our layout."""
    dt = torch_dtype(dtype)
    pre = "vision_tower.vision_model."

    def get(name):
        return fetch(pre + name).to(dt)

    def lyr(suffix):
        return lambda i: f"encoder.layers.{i}.{suffix}"

    names = {"ln1_w": (lyr("layer_norm1.weight"), False),
             "ln1_b": (lyr("layer_norm1.bias"), False)}
    for ours, hf in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "out_proj")):
        names[f"w{ours}"] = (lyr(f"self_attn.{hf}.weight"), True)
        names[f"b{ours}"] = (lyr(f"self_attn.{hf}.bias"), False)
    names.update({"ln2_w": (lyr("layer_norm2.weight"), False),
                  "ln2_b": (lyr("layer_norm2.bias"), False),
                  "fc1_w": (lyr("mlp.fc1.weight"), True), "fc1_b": (lyr("mlp.fc1.bias"), False),
                  "fc2_w": (lyr("mlp.fc2.weight"), True), "fc2_b": (lyr("mlp.fc2.bias"), False)})
    # HF conv weight [D, C, P, P] -> [P, P, C, D]
    conv = get("embeddings.patch_embedding.weight").permute(2, 3, 1, 0).contiguous()
    return {
        "patch_w": conv,
        "patch_b": get("embeddings.patch_embedding.bias"),
        "pos_emb": get("embeddings.position_embedding.weight"),
        "layers": {k: v.contiguous() for k, v in
                   _stack_layers(get, vcfg.num_layers, names).items()},
        "post_ln_w": get("post_layernorm.weight"),
        "post_ln_b": get("post_layernorm.bias"),
        "mm_norm": fetch("multi_modal_projector.mm_soft_emb_norm.weight").to(dt),
        "mm_proj": fetch("multi_modal_projector.mm_input_projection_weight").to(dt),
    }


def load_qwen3vl_vision_params(vcfg: VisionConfig, fetch, dtype="float32") -> Params:
    """HF ``model.visual.*`` (Qwen3-VL) into our layout."""
    dt = torch_dtype(dtype)

    def get(name):
        return fetch("model.visual." + name).to(dt)

    def lyr(suffix):
        return lambda i: f"blocks.{i}.{suffix}"

    names = {}
    for ours, hf, tr in (("ln1_w", "norm1.weight", False), ("ln1_b", "norm1.bias", False),
                         ("qkv_w", "attn.qkv.weight", True), ("qkv_b", "attn.qkv.bias", False),
                         ("proj_w", "attn.proj.weight", True),
                         ("proj_b", "attn.proj.bias", False),
                         ("ln2_w", "norm2.weight", False), ("ln2_b", "norm2.bias", False),
                         ("fc1_w", "mlp.linear_fc1.weight", True),
                         ("fc1_b", "mlp.linear_fc1.bias", False),
                         ("fc2_w", "mlp.linear_fc2.weight", True),
                         ("fc2_b", "mlp.linear_fc2.bias", False)):
        names[ours] = (lyr(hf), tr)

    def merger(prefix):
        return {"norm_w": get(prefix + "norm.weight"), "norm_b": get(prefix + "norm.bias"),
                "fc1_w": get(prefix + "linear_fc1.weight").T.contiguous(),
                "fc1_b": get(prefix + "linear_fc1.bias"),
                "fc2_w": get(prefix + "linear_fc2.weight").T.contiguous(),
                "fc2_b": get(prefix + "linear_fc2.bias")}

    # conv3d weight [D, C, tp, p, p] -> [C * tp * p * p, D], the patch
    # features' (channel, temporal, ph, pw) order
    conv = get("patch_embed.proj.weight")
    return {
        "patch_w": conv.reshape(conv.shape[0], -1).T.contiguous(),
        "patch_b": get("patch_embed.proj.bias"),
        "pos_emb": get("pos_embed.weight"),
        "layers": {k: v.contiguous() for k, v in
                   _stack_layers(get, vcfg.num_layers, names).items()},
        "merger": merger("merger."),
        "deepstack": [merger(f"deepstack_merger_list.{i}.")
                      for i in range(len(vcfg.deepstack_indexes))],
    }


# ---------------------------------------------------------------------------
# Qwen3-VL positions
# ---------------------------------------------------------------------------

def qwen_mrope_positions(tokens, image_token_id: int, tokens_per_image: int,
                         prompt_len: Optional[int] = None, grids: Optional[list] = None):
    """Qwen3-VL's 3-axis rope positions for a prompt with image runs (the
    JAX function): text advances all three axes together; an image's soft
    tokens share the temporal position and spread (h, w) over the merged
    grid, and the running position then advances by the grid's longer
    side. ``grids``: each image's merged (rows, cols), None for square
    grids; tokens at or past ``prompt_len`` are generated text, whatever
    their id. Returns (pos3 [3, T] int32, delta), delta the offset a
    continuation adds to its token index."""
    g = int(round(tokens_per_image ** 0.5))
    T = len(tokens)
    if prompt_len is None:
        prompt_len = T
    pos = np.zeros((3, T), np.int32)
    cur = i = img_i = 0
    while i < T:
        if i < prompt_len and tokens[i] == image_token_id:
            gh, gw = (g, g) if grids is None else grids[img_i]
            if gh * gw != tokens_per_image:
                raise ValueError(f"grid {gh}x{gw} does not hold {tokens_per_image} "
                                 f"soft tokens")
            img_i += 1
            base = cur
            for r in range(gh):
                for c in range(gw):
                    if i >= T or tokens[i] != image_token_id:
                        raise ValueError("truncated image soft-token run")
                    pos[0, i], pos[1, i], pos[2, i] = base, base + r, base + c
                    i += 1
            cur = base + max(gh, gw)
        else:
            pos[:, i] = cur
            cur += 1
            i += 1
    return pos, cur - T


def merged_grid(vcfg: VisionConfig, pixels_shape) -> tuple[int, int]:
    """An image's merged grid (rows, cols) from its pixel shape [H, W, C]."""
    d = vcfg.patch_size * vcfg.spatial_merge_size
    return pixels_shape[0] // d, pixels_shape[1] // d

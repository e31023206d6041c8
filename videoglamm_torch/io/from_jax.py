"""JAX parameter tree -> videoglamm_torch state_dict.

Takes the flax parameter tree of a videoglamm_tpu model as nested dicts of
numpy arrays (or anything `np.asarray` reads, so no jax is needed here) and
returns the port's `state_dict`. It inverts the layout mapping of
`videoglamm_tpu/io/import_torch.py`:

- flax Dense kernels [in, out] become nn.Linear weights [out, in];
- scanned layers (a stacked leading L axis from `nn.scan`) become per-layer
  modules;
- conv kernels [kh, kw, in, out] become [out, in, kh, kw], and flax
  ConvTranspose kernels, which import_torch.py flips, are flipped back;
- the port's names are the reference checkpoint keys that import_torch.py
  reads, under the port's submodule prefixes.

Quantised LLM trees (`quantize_phi3_params` / `_int4` of import_torch.py:
`{"kernel": int8 [L, in, out], "scale": f32 [L, out]}`, int4
`{"kernel": packed int8 [L, in/2, out], "scale": f32 [L, in/group, out]}`,
the lm_head unstacked) become the buffers of the port's `QDense` /
`QDense4`: transposed to [out, in] (int8 padded with zero rows to a
multiple of 8, as `QDense` holds it) resp. [out, in/2] and [out, in/group].
The transpose keeps the nibble order along K: packed byte r of a row still
holds k = 2r low and k = 2r + 1 high.

A tree initialised without the tracker has no leaves for the memory
encoder, the memory attention, `obj_ptr_proj`, `mask_downsample` or the
prompt encoder's mask-prompt convs; the state dict then has none either
(`VideoGLaMM.load_weights` takes such a one).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

from .. import config as _config


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.float32)))


def _linear(p, prefix: str, layer=None) -> Dict[str, torch.Tensor]:
    def pick(a):
        a = np.asarray(a)
        return a if layer is None else a[layer]
    out = {f"{prefix}.weight": _t(pick(p["kernel"]).T)}
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(pick(p["bias"]))
    return out


def _qlinear(p, prefix: str, layer=None) -> Dict[str, torch.Tensor]:
    """A quantised flax projection -> QDense / QDense4 buffers; a float one
    -> an nn.Linear weight. int8 scales are [out], int4 scales
    [in/group, out]."""
    kernel = np.asarray(p["kernel"])
    if kernel.dtype != np.int8:
        return _linear(p, prefix, layer)
    scale = np.asarray(p["scale"], dtype=np.float32)
    if layer is not None:
        kernel, scale = kernel[layer], scale[layer]
    w = np.array(kernel.T, order="C")
    if scale.ndim == 1:                          # int8: pad rows to 8
        w = np.pad(w, ((0, -w.shape[0] % 8), (0, 0)))
    return {f"{prefix}.weight": torch.from_numpy(w),
            f"{prefix}.scale": torch.from_numpy(np.array(scale.T, order="C"))}


def _norm(p, prefix: str, layer=None) -> Dict[str, torch.Tensor]:
    def pick(a):
        a = np.asarray(a)
        return a if layer is None else a[layer]
    out = {f"{prefix}.weight": _t(pick(p["scale"]))}
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(pick(p["bias"]))
    return out


def _conv_hwio(k) -> torch.Tensor:
    """[kh, kw, in, out] -> [out, in, kh, kw]."""
    return _t(np.asarray(k).transpose(3, 2, 0, 1))


def _prefixed(prefix: str, sd: Mapping[str, torch.Tensor]):
    return {f"{prefix}.{k}": v for k, v in sd.items()}


def clip_state_dict(p) -> Dict[str, torch.Tensor]:
    """CLIPVisionTower params -> port CLIPVisionTower state_dict."""
    sd = {"embeddings.class_embedding": _t(p["class_embedding"]),
          "embeddings.patch_embedding.weight": _conv_hwio(p["patch_embedding"]),
          "embeddings.position_embedding.weight": _t(p["position_embedding"])}
    sd.update(_norm(p["pre_layrnorm"], "pre_layrnorm"))
    i = 0
    while f"layers_{i}" in p:
        lp, pre = p[f"layers_{i}"], f"encoder.layers.{i}"
        sd.update(_norm(lp["layer_norm1"], f"{pre}.layer_norm1"))
        sd.update(_norm(lp["layer_norm2"], f"{pre}.layer_norm2"))
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd.update(_linear(lp["self_attn"][n], f"{pre}.self_attn.{n}"))
        sd.update(_linear(lp["mlp_fc1"], f"{pre}.mlp.fc1"))
        sd.update(_linear(lp["mlp_fc2"], f"{pre}.mlp.fc2"))
        i += 1
    return sd


def internvideo2_state_dict(p) -> Dict[str, torch.Tensor]:
    """InternVideo2Tower params (scanned `blocks`) -> port state_dict."""
    k = np.asarray(p["patch_embedding"]).transpose(3, 2, 0, 1)[:, :, None]
    sd = {"patch_embed.proj.weight": _t(k),
          "patch_embed.proj.bias": _t(p["patch_bias"]),
          "cls_token": _t(p["cls_token"]),
          "pos_embed": _t(np.asarray(p["pos_embed"])[None])}
    b = p["blocks"]
    n = np.asarray(b["norm1"]["scale"]).shape[0]
    for i in range(n):
        pre = f"blocks.{i}"
        sd.update(_norm(b["norm1"], f"{pre}.norm1", i))
        sd.update(_norm(b["norm2"], f"{pre}.norm2", i))
        sd.update(_linear(b["qkv"], f"{pre}.attn.qkv", i))
        for nm in ("q_norm", "k_norm"):
            if nm in b:
                sd.update(_norm(b[nm], f"{pre}.attn.{nm}", i))
        sd.update(_linear(b["attn_proj"], f"{pre}.attn.proj", i))
        sd.update(_linear(b["mlp_fc1"], f"{pre}.mlp.fc1", i))
        sd.update(_linear(b["mlp_fc2"], f"{pre}.mlp.fc2", i))
        sd[f"{pre}.ls1.gamma"] = _t(np.asarray(b["ls1_gamma"])[i])
        sd[f"{pre}.ls2.gamma"] = _t(np.asarray(b["ls2_gamma"])[i])
    return sd


def phi3_state_dict(p) -> Dict[str, torch.Tensor]:
    """Phi3ForCausalLM params (scanned `model/layers`) -> HF-named
    state_dict of the port's Phi3ForCausalLM, float or quantised, with the
    LoRA leaves where the tree has them."""
    lay = p["model"]["layers"]
    sd = {"model.embed_tokens.weight": _t(p["embed_tokens"]["embedding"]),
          "model.norm.weight": _t(p["model"]["norm"]["scale"])}
    sd.update(_qlinear(p["lm_head"], "lm_head"))
    n = np.asarray(lay["input_layernorm"]["scale"]).shape[0]
    for i in range(n):
        pre = f"model.layers.{i}"
        sd.update(_norm(lay["input_layernorm"], f"{pre}.input_layernorm", i))
        sd.update(_norm(lay["post_attention_layernorm"],
                        f"{pre}.post_attention_layernorm", i))
        sd.update(_qlinear(lay["qkv_proj"], f"{pre}.self_attn.qkv_proj", i))
        sd.update(_qlinear(lay["o_proj"], f"{pre}.self_attn.o_proj", i))
        sd.update(_qlinear(lay["gate_up_proj"], f"{pre}.mlp.gate_up_proj", i))
        sd.update(_qlinear(lay["down_proj"], f"{pre}.mlp.down_proj", i))
        # LoRA leaves of a tree made with lora_rank > 0, stacked on the scan
        # axis like the rest: [L, in, r] -> per-layer [r, in]
        for nm in ("q_lora_a", "q_lora_b", "v_lora_a", "v_lora_b"):
            if nm in lay:
                sd.update(_linear(lay[nm], f"{pre}.self_attn.{nm}", i))
    return sd


def llama_state_dict(p) -> Dict[str, torch.Tensor]:
    """LlamaForCausalLM params (flax scans the layers: every leaf under
    `layers` has a leading layer axis) -> HF-named state_dict of the port's
    LlamaForCausalLM, the keys `import_llama` reads (import_torch.py:555)."""
    lay = p["layers"]
    sd = {"model.embed_tokens.weight": _t(p["embed_tokens"]["embedding"]),
          "model.norm.weight": _t(p["norm"]["scale"])}
    sd.update(_linear(p["lm_head"], "lm_head"))
    n = np.asarray(lay["input_layernorm"]["scale"]).shape[0]
    for i in range(n):
        pre = f"model.layers.{i}"
        sd.update(_norm(lay["input_layernorm"], f"{pre}.input_layernorm", i))
        sd.update(_norm(lay["post_attention_layernorm"],
                        f"{pre}.post_attention_layernorm", i))
        for nm in ("q_proj", "k_proj", "v_proj", "o_proj"):
            sd.update(_linear(lay[nm], f"{pre}.self_attn.{nm}", i))
        for nm in ("gate_proj", "up_proj", "down_proj"):
            sd.update(_linear(lay[nm], f"{pre}.mlp.{nm}", i))
    return sd


def projector_state_dict(p, projector_type: str) -> Dict[str, torch.Tensor]:
    if projector_type == "identity":
        return {}
    if projector_type == "linear":
        return {k.split(".", 1)[1]: v for k, v in _linear(p["fc0"], "x").items()}
    if projector_type == "mlp2x_gelu":
        return {**_linear(p["fc0"], "0"), **_linear(p["fc1"], "2")}
    raise ValueError(projector_type)


def hiera_state_dict(p) -> Dict[str, torch.Tensor]:
    sd = {"patch_embed.proj.weight": _conv_hwio(p["patch_embed"]["kernel"]),
          "patch_embed.proj.bias": _t(p["patch_embed"]["bias"]),
          "pos_embed": _t(np.asarray(p["pos_embed"]).transpose(2, 0, 1)[None]),
          "pos_embed_window": _t(
              np.asarray(p["pos_embed_window"]).transpose(2, 0, 1)[None])}
    i = 0
    while f"blocks_{i}" in p:
        bp, pre = p[f"blocks_{i}"], f"blocks.{i}"
        sd.update(_norm(bp["norm1"], f"{pre}.norm1"))
        sd.update(_norm(bp["norm2"], f"{pre}.norm2"))
        sd.update(_linear(bp["attn"]["qkv"], f"{pre}.attn.qkv"))
        sd.update(_linear(bp["attn"]["proj"], f"{pre}.attn.proj"))
        sd.update(_linear(bp["mlp"]["fc1"], f"{pre}.mlp.layers.0"))
        sd.update(_linear(bp["mlp"]["fc2"], f"{pre}.mlp.layers.1"))
        if "proj" in bp:
            sd.update(_linear(bp["proj"], f"{pre}.proj"))
        i += 1
    return sd


def _conv1x1(p, prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(np.asarray(p["kernel"]).T[:, :, None, None]),
            f"{prefix}.bias": _t(p["bias"])}


def _conv_transpose(p, prefix: str) -> Dict[str, torch.Tensor]:
    k = np.asarray(p["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1)
    return {f"{prefix}.weight": _t(k), f"{prefix}.bias": _t(p["bias"])}


def _mlp_block(p, prefix: str) -> Dict[str, torch.Tensor]:
    sd, j = {}, 0
    while f"layers_{j}" in p:
        sd.update(_linear(p[f"layers_{j}"], f"{prefix}.layers.{j}"))
        j += 1
    return sd


def _sam_decoder_common(p, mlp_names) -> Dict[str, torch.Tensor]:
    """What the SAM-2 and SAM-1 mask decoders share: the tokens but the
    object-score one, the two-way transformer (its blocks' MLP under
    `mlp_names`), the upscaling, the hypernetworks and the IoU head."""
    sd = {"iou_token.weight": _t(p["iou_token"]),
          "mask_tokens.weight": _t(p["mask_tokens"])}
    tp = p["transformer"]
    i = 0
    while f"layers_{i}" in tp:
        lp, pre = tp[f"layers_{i}"], f"transformer.layers.{i}"
        for nm in ("self_attn", "cross_attn_token_to_image",
                   "cross_attn_image_to_token"):
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                sd.update(_linear(lp[nm][proj], f"{pre}.{nm}.{proj}"))
        for leaf, name in zip(("fc1", "fc2"), mlp_names):
            sd.update(_linear(lp["mlp"][leaf], f"{pre}.mlp.{name}"))
        for nm in ("norm1", "norm2", "norm3", "norm4"):
            sd.update(_norm(lp[nm], f"{pre}.{nm}"))
        i += 1
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        sd.update(_linear(tp["final_attn_token_to_image"][proj],
                          f"transformer.final_attn_token_to_image.{proj}"))
    sd.update(_norm(tp["norm_final_attn"], "transformer.norm_final_attn"))
    sd.update(_conv_transpose(p["upscale_conv1"], "output_upscaling.0"))
    sd.update(_norm(p["upscale_ln"], "output_upscaling.1"))
    sd.update(_conv_transpose(p["upscale_conv2"], "output_upscaling.3"))
    j = 0
    while f"hyper_mlps_{j}" in p:
        sd.update(_mlp_block(p[f"hyper_mlps_{j}"],
                             f"output_hypernetworks_mlps.{j}"))
        j += 1
    sd.update(_mlp_block(p["iou_head"], "iou_prediction_head"))
    return sd


def mask_decoder_state_dict(p, conv_s0=None, conv_s1=None):
    """MaskDecoder params (+ SAM2Base conv_s0/s1) -> port MaskDecoder."""
    sd = {"obj_score_token.weight": _t(p["obj_score_token"])}
    sd.update(_sam_decoder_common(p, ("layers.0", "layers.1")))
    sd.update(_mlp_block(p["obj_score_head"], "pred_obj_score_head"))
    if conv_s0 is not None:
        sd.update(_conv1x1(conv_s0, "conv_s0"))
        sd.update(_conv1x1(conv_s1, "conv_s1"))
    return sd


def image_encoder_state_dict(p) -> Dict[str, torch.Tensor]:
    """SAM2ImageEncoder params (trunk + neck) -> port state_dict."""
    sd = _prefixed("trunk", hiera_state_dict(p["trunk"]))
    j = 0
    while f"convs_{j}" in p["neck"]:
        sd.update(_conv1x1(p["neck"][f"convs_{j}"], f"neck.convs.{j}.conv"))
        j += 1
    return sd


def prompt_encoder_state_dict(p) -> Dict[str, torch.Tensor]:
    """PromptEncoder params -> port PromptEncoder: the random-Fourier
    matrix, the four point-label embeddings, the not-a-point and no-mask
    embeddings, and, where the tree has them, the mask-prompt convs and
    norms under the reference names `mask_downscaling.{0,1,3,4,6}`
    (videoglamm_tpu/io/import_torch.py:256-260)."""
    sd = {"pe_layer.positional_encoding_gaussian_matrix": _t(p["pe_gauss"]),
          "not_a_point_embed.weight": _t(np.asarray(p["not_a_point_embed"])[None]),
          "no_mask_embed.weight": _t(np.asarray(p["no_mask_embed"])[None])}
    for i, row in enumerate(np.asarray(p["point_embeddings"])):
        sd[f"point_embeddings.{i}.weight"] = _t(row[None])
    if "mask_conv1" in p:
        for leaf, idx in (("mask_conv1", 0), ("mask_conv2", 3), ("mask_conv3", 6)):
            sd.update(_conv(p[leaf], f"mask_downscaling.{idx}"))
        for leaf, idx in (("mask_ln1", 1), ("mask_ln2", 4)):
            sd.update(_norm(p[leaf], f"mask_downscaling.{idx}"))
    return sd


def _conv(p, prefix: str) -> Dict[str, torch.Tensor]:
    """flax nn.Conv (HWIO; a depthwise kernel is [kh, kw, 1, C]) -> Conv2d."""
    return {f"{prefix}.weight": _conv_hwio(p["kernel"]),
            f"{prefix}.bias": _t(p["bias"])}


def memory_encoder_state_dict(p) -> Dict[str, torch.Tensor]:
    """MemoryEncoder params -> port MemoryEncoder, under the reference
    checkpoint's names (mask_downsampler.encoder.{0,1,3,...,12},
    fuser.layers.*, the layer scale as `weight`)."""
    sd = {}
    enc = "mask_downsampler.encoder"
    for i in range(4):
        sd.update(_conv(p[f"mask_down_{i}"], f"{enc}.{3 * i}"))
        sd.update(_norm(p[f"mask_down_ln_{i}"], f"{enc}.{3 * i + 1}"))
    sd.update(_conv(p["mask_down_out"], f"{enc}.12"))
    sd.update(_conv1x1(p["pix_feat_proj"], "pix_feat_proj"))
    sd.update(_conv1x1(p["out_proj"], "out_proj"))
    i = 0
    while f"fuser_{i}" in p:
        fp, pre = p[f"fuser_{i}"], f"fuser.layers.{i}"
        sd.update(_conv(fp["dwconv"], f"{pre}.dwconv"))
        sd.update(_norm(fp["norm"], f"{pre}.norm"))
        sd.update(_linear(fp["pwconv1"], f"{pre}.pwconv1"))
        sd.update(_linear(fp["pwconv2"], f"{pre}.pwconv2"))
        sd[f"{pre}.weight"] = _t(fp["gamma"])
        i += 1
    return sd


def memory_attention_state_dict(p) -> Dict[str, torch.Tensor]:
    """MemoryAttention params -> port MemoryAttention (layers.{i}.*)."""
    sd = _norm(p["norm"], "norm")
    i = 0
    while f"layers_{i}" in p:
        lp, pre = p[f"layers_{i}"], f"layers.{i}"
        for nm in ("self_attn", "cross_attn_image"):
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                sd.update(_linear(lp[nm][proj], f"{pre}.{nm}.{proj}"))
        sd.update(_linear(lp["linear1"], f"{pre}.linear1"))
        sd.update(_linear(lp["linear2"], f"{pre}.linear2"))
        for nm in ("norm1", "norm2", "norm3"):
            sd.update(_norm(lp[nm], f"{pre}.{nm}"))
        i += 1
    return sd


def sam2_state_dict(p) -> Dict[str, torch.Tensor]:
    """SAM2Base params -> port SAM2Base state_dict. The tracker's submodules
    are converted where the tree has them."""
    sd = _prefixed("image_encoder", image_encoder_state_dict(p["image_encoder"]))
    sd.update(_prefixed("sam_prompt_encoder",
                        prompt_encoder_state_dict(p["sam_prompt_encoder"])))
    sd.update(_prefixed("sam_mask_decoder", mask_decoder_state_dict(
        p["sam_mask_decoder"], p.get("conv_s0"), p.get("conv_s1"))))
    if "memory_encoder" in p:
        sd.update(_prefixed("memory_encoder",
                            memory_encoder_state_dict(p["memory_encoder"])))
    if "memory_attention" in p:
        sd.update(_prefixed("memory_attention",
                            memory_attention_state_dict(p["memory_attention"])))
    if "obj_ptr_proj" in p:
        sd.update(_mlp_block(p["obj_ptr_proj"], "obj_ptr_proj"))
    if "mask_downsample" in p:
        sd.update(_conv(p["mask_downsample"], "mask_downsample"))
    sd["no_mem_embed"] = _t(p["no_mem_embed"])
    sd["no_mem_pos_enc"] = _t(p["no_mem_pos_enc"])
    tpos = np.asarray(p["maskmem_tpos_enc"])             # [num_maskmem, 1, md]
    sd["maskmem_tpos_enc"] = _t(tpos[:, :, None, :])
    sd["no_obj_ptr"] = _t(np.asarray(p["no_obj_ptr"])[None])
    return sd


def sam1_block_state_dict(bp) -> Dict[str, torch.Tensor]:
    """SAM1Block params -> port SAM1Block state_dict."""
    sd = {"attn.rel_pos_h": _t(bp["attn"]["rel_pos_h"]),
          "attn.rel_pos_w": _t(bp["attn"]["rel_pos_w"])}
    sd.update(_norm(bp["norm1"], "norm1"))
    sd.update(_norm(bp["norm2"], "norm2"))
    sd.update(_linear(bp["attn"]["qkv"], "attn.qkv"))
    sd.update(_linear(bp["attn"]["proj"], "attn.proj"))
    sd.update(_linear(bp["mlp"]["fc1"], "mlp.lin1"))
    sd.update(_linear(bp["mlp"]["fc2"], "mlp.lin2"))
    return sd


def sam1_state_dict(p) -> Dict[str, torch.Tensor]:
    """SAM1 params (models/sam1.py) -> port SAM1 state_dict, under the keys
    `import_sam1` reads (import_torch.py:419-497): segment_anything's
    `mlp.lin1` / `lin2`, `neck.{0,1,2,3}`, `itm_head.mlp{1,2}.0`."""
    e = p["image_encoder"]
    sd = {"patch_embed.proj.weight": _conv_hwio(e["patch_embedding"]),
          "patch_embed.proj.bias": _t(e["patch_bias"]),
          "pos_embed": _t(np.asarray(e["pos_embed"])[None]),
          "neck.0.weight": _t(np.asarray(e["neck_conv1"]["kernel"]).T[:, :, None, None]),
          "neck.2.weight": _conv_hwio(e["neck_conv2"]["kernel"])}
    sd.update(_norm(e["neck_ln1"], "neck.1"))
    sd.update(_norm(e["neck_ln2"], "neck.3"))
    i = 0
    while f"blocks_{i}" in e:
        sd.update(_prefixed(f"blocks.{i}", sam1_block_state_dict(e[f"blocks_{i}"])))
        i += 1
    d = p["mask_decoder"]
    dec = _sam_decoder_common(d, ("lin1", "lin2"))
    if "itm_fc1" in d:
        dec.update(_linear(d["itm_fc1"], "itm_head.mlp1.0"))
        dec.update(_linear(d["itm_fc2"], "itm_head.mlp2.0"))
    sd = _prefixed("image_encoder", sd)
    sd.update(_prefixed("prompt_encoder",
                        prompt_encoder_state_dict(p["prompt_encoder"])))
    sd.update(_prefixed("mask_decoder", dec))
    return sd


def videoglamm_state_dict(params, cfg) -> Dict[str, torch.Tensor]:
    """Composite VideoGLaMM params (with or without the outer "params"
    collection) -> port VideoGLaMM state_dict."""
    p = params.get("params", params)
    sd = {}
    sd.update(_prefixed("vision_tower", internvideo2_state_dict(p["vision_tower"])))
    sd.update(_prefixed("image_vision_tower",
                        clip_state_dict(p["image_vision_tower"])))
    for name in ("mm_projector", "image_mm_projector"):
        sd.update(_prefixed(name, projector_state_dict(p[name],
                                                       cfg.mm_projector_type)))
    llm_sd = phi3_state_dict if cfg.llm_type == "phi3" else llama_state_dict
    sd.update(_prefixed("llm", llm_sd(p["llm"])))
    sd.update(_linear(p["text_hidden_fcs"]["fc0"], "text_hidden_fcs.0.0"))
    sd.update(_linear(p["text_hidden_fcs"]["fc1"], "text_hidden_fcs.0.2"))
    sd.update(_prefixed("visual_model", sam2_state_dict(p["sam"])))
    return sd


def port_config(jcfg):
    """A videoglamm_tpu config dataclass -> the port's config of the same
    class name, field by field (nested configs too). JAX fields that the
    port does not read are dropped."""
    cls = getattr(_config, type(jcfg).__name__)
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(jcfg, f.name)
        kw[f.name] = port_config(v) if dataclasses.is_dataclass(v) else v
    return cls(**kw)

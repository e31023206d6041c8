"""SAM-2 base model (PyTorch port of videoglamm_tpu/models/sam2/
sam2_base.py): the image encoder, prompt encoder, mask decoder, memory
encoder and memory attention, composed functionally, with the VideoGLaMM
text-prompt extension (`text_inputs` threaded into the prompt encoder) and
the object-score / object-pointer handling. The per-frame state of tracking
lives in video_predictor.py as a fixed-shape memory bank, consumed here by
`condition_features` through a boolean attention mask.

The image encoder runs in the compute dtype (bf16); the prompt encoder,
the mask decoder, the memory encoder, the memory attention, `obj_ptr_proj`
and the memory parameters stay f32, as sam2_base.py:49-75 keeps them.
`forward_sam_heads` takes points, mask prompts and text prompts;
`use_mask_as_output` turns a given mask into the heads' output, as the
interactive predictor's mask prompts do.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ...config import SAM2Config
from ...ops.resize import resize_bilinear, resize_bilinear_antialias
from ..common import MLPBlock
from .fpn import SAM2ImageEncoder, conv1x1_nhwc
from .mask_decoder import MaskDecoder
from .memory import MemoryAttention, MemoryEncoder, _conv_nhwc
from .prompt_encoder import PromptEncoder

NO_OBJ_SCORE = -1024.0


class SamHeadsOutput(NamedTuple):
    low_res_multimasks: torch.Tensor   # [B, M, 4E, 4E]
    high_res_multimasks: torch.Tensor  # [B, M, S, S]
    ious: torch.Tensor                 # [B, M]
    low_res_masks: torch.Tensor        # [B, 1, 4E, 4E] best mask
    high_res_masks: torch.Tensor       # [B, 1, S, S]
    obj_ptr: torch.Tensor              # [B, C]
    object_score_logits: torch.Tensor  # [B, 1]


def model_device(model) -> torch.device:
    """The device a built SAM2Base or SAM1 lives on."""
    return next(model.parameters()).device


class SAM2Base(nn.Module):
    def __init__(self, cfg: SAM2Config):
        super().__init__()
        self.cfg = cfg
        C = cfg.d_model
        self.image_encoder = SAM2ImageEncoder(cfg)
        self.sam_prompt_encoder = PromptEncoder(cfg)
        self.sam_mask_decoder = MaskDecoder(cfg)
        self.memory_encoder = MemoryEncoder(cfg)
        self.memory_attention = MemoryAttention(cfg)
        # memory parameters (sam2_base.py:59-75), with the reference
        # checkpoint's shapes
        self.no_mem_embed = nn.Parameter(torch.zeros(1, 1, C))
        self.no_mem_pos_enc = nn.Parameter(torch.zeros(1, 1, C))
        self.maskmem_tpos_enc = nn.Parameter(
            torch.zeros(cfg.num_maskmem, 1, 1, cfg.mem_dim))
        self.no_obj_ptr = nn.Parameter(torch.zeros(1, C))
        self.obj_ptr_proj = MLPBlock(C, C, C, 3)
        self.mask_downsample = nn.Conv2d(1, 1, 4, stride=4)

    def forward_image(self, images):
        """images [B, S, S, 3] (SAM-normalised) -> (feats, pos): 3 levels,
        highest resolution first; levels 0/1 already through conv_s0/s1
        (sam2_base.py:78-84)."""
        feats, pos = self.image_encoder(images)
        dec = self.sam_mask_decoder
        feats = [conv1x1_nhwc(feats[0], dec.conv_s0),
                 conv1x1_nhwc(feats[1], dec.conv_s1), feats[2]]
        return feats, pos

    def forward_sam_heads(self, backbone_features, text_inputs=None,
                          high_res_features=None,
                          multimask_output: bool = False,
                          training: bool = False, *, point_inputs=None,
                          mask_inputs=None) -> SamHeadsOutput:
        """Prompt encoder + mask decoder (sam2_base.py:87-148): the points
        (coords [B, P, 2], labels [B, P]; one padding point, label -1,
        without them), the mask prompt [B, h, w, 1] (resized to 4E x 4E
        where it is not), the text prompts; multimask argmax; the mask
        logits of an absent object set to NO_OBJ_SCORE; the object pointer
        mixed hard with `no_obj_ptr`."""
        cfg = self.cfg
        B = backbone_features.shape[0]
        dev = backbone_features.device
        if point_inputs is None:
            coords = torch.zeros(B, 1, 2, device=dev)
            labels = -torch.ones(B, 1, dtype=torch.int32, device=dev)
        else:
            coords, labels = point_inputs
        mask_prompt = None
        if mask_inputs is not None:
            tgt = 4 * (cfg.image_size // cfg.backbone_stride)
            mask_prompt = mask_inputs.float()
            if mask_inputs.shape[1] != tgt:
                mask_prompt = resize_bilinear(mask_prompt, (tgt, tgt))
        sparse, dense = self.sam_prompt_encoder(
            text_embeds=text_inputs, points=(coords, labels), masks=mask_prompt)
        dec = self.sam_mask_decoder(
            backbone_features, self.sam_prompt_encoder.get_dense_pe(), sparse,
            dense, multimask_output=multimask_output,
            high_res_features=high_res_features, training=training)

        is_obj_appearing = dec.object_score_logits > 0          # [B, 1]
        low_res_multimasks = torch.where(is_obj_appearing[:, None, None],
                                         dec.masks.float(), NO_OBJ_SCORE)
        high_res_multimasks = resize_bilinear(
            low_res_multimasks.permute(0, 2, 3, 1),
            (cfg.image_size, cfg.image_size)).permute(0, 3, 1, 2)

        sam_output_token = dec.sam_tokens_out[:, 0]
        if multimask_output:
            best = dec.iou_pred.argmax(dim=-1)
            bidx = torch.arange(B, device=dev)
            low_res_masks = low_res_multimasks[bidx, best][:, None]
            high_res_masks = high_res_multimasks[bidx, best][:, None]
            if dec.sam_tokens_out.shape[1] > 1:
                sam_output_token = dec.sam_tokens_out[bidx, best]
        else:
            low_res_masks, high_res_masks = low_res_multimasks, high_res_multimasks

        obj_ptr = self.obj_ptr_proj(sam_output_token)
        lam = is_obj_appearing.float()
        obj_ptr = lam * obj_ptr + (1.0 - lam) * self.no_obj_ptr
        return SamHeadsOutput(low_res_multimasks, high_res_multimasks,
                              dec.iou_pred, low_res_masks, high_res_masks,
                              obj_ptr, dec.object_score_logits)

    def use_mask_as_output(self, backbone_features, high_res_features,
                           mask_inputs) -> SamHeadsOutput:
        """A given binary mask [B, S, S, 1] as the heads' output
        (sam2_base.py:151-175): logits +-10, the low-res masks through the
        antialiased bilinear downsample, IoU 1, the object pointer from a
        decode prompted by the mask (through `mask_downsample`), and the
        object score +10 where the mask has a pixel, else -10 with
        `no_obj_ptr`."""
        out_scale, out_bias = 20.0, -10.0
        m = mask_inputs.float()
        high = (m * out_scale + out_bias).permute(0, 3, 1, 2)    # [B, 1, S, S]
        S = high.shape[-1]
        low = resize_bilinear_antialias(high, (S // 4, S // 4),
                                        channels_last=False)
        ious = torch.ones(m.shape[0], 1, device=m.device)
        heads = self.forward_sam_heads(
            backbone_features, high_res_features=high_res_features,
            mask_inputs=_conv_nhwc(m, self.mask_downsample))
        is_obj = (m.reshape(m.shape[0], -1) > 0).any(dim=1, keepdim=True).float()
        obj_ptr = is_obj * heads.obj_ptr + (1.0 - is_obj) * self.no_obj_ptr
        return SamHeadsOutput(low, high, ious, low, high, obj_ptr,
                              out_scale * is_obj + out_bias)

    def encode_new_memory(self, pix_feat, high_res_masks, object_score_logits,
                          binarize: bool = False):
        """pix_feat [B, E, E, C]; high_res_masks [B, S, S, 1] logits ->
        (memory [B, E*E, mem_dim], pos [E*E, mem_dim]). binarize=True
        thresholds the logits at 0 instead of the sigmoid, as the video
        predictor does for prompted frames (sam2_base.py:177-197).
        `object_score_logits` is accepted and unused, as in the JAX
        method."""
        cfg = self.cfg
        if binarize:
            m = (high_res_masks > 0).float()
        else:
            m = torch.sigmoid(high_res_masks.float())
        m = m * cfg.sigmoid_scale_for_mem_enc + cfg.sigmoid_bias_for_mem_enc
        mem, pos = self.memory_encoder(pix_feat, m)
        B, E = mem.shape[0], mem.shape[1]
        return mem.reshape(B, E * E, cfg.mem_dim), pos.reshape(E * E, cfg.mem_dim)

    def condition_features(self, curr_feat, curr_pos, memory, memory_pos,
                           num_obj_ptr_tokens: int, kv_mask):
        """The current frame's features conditioned on the memory.
        curr_feat/curr_pos [B, E, E, C]; memory [B, M, mem_dim] (spatial
        memories, then the object-pointer tokens); kv_mask [B, M] bool.
        (sam2_base.py:200-220 with use_memory all true, which is how the
        tracker calls it; the no-memory init frame adds `no_mem_embed`
        itself, video_predictor.py:190.)"""
        B, E, _, C = curr_feat.shape
        conditioned = self.memory_attention(
            curr_feat.reshape(B, E * E, C).float(),
            curr_pos.reshape(B, E * E, C).float(), memory.float(),
            memory_pos.float(), num_obj_ptr_tokens, kv_mask)
        return conditioned.reshape(B, E, E, C).to(curr_feat.dtype)

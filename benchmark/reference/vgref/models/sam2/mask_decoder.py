"""SAM-2 mask decoder (PyTorch port of
videoglamm_tpu/models/sam2/mask_decoder.py). Runs in f32 even in the bf16
model (sam2_base.py:51). Owns the high-res skip projections conv_s0 /
conv_s1, as the reference module does."""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ...config import SAM2Config
from ..common import LayerNorm, MLPBlock
from .transformer import TwoWayTransformer


class MaskDecoderOutput(NamedTuple):
    masks: torch.Tensor                # [B, M, 4E, 4E] selected mask logits
    iou_pred: torch.Tensor             # [B, M]
    sam_tokens_out: torch.Tensor       # [B, M, C]
    object_score_logits: torch.Tensor  # [B, 1]


def _conv_transpose_2x(x, conv: nn.ConvTranspose2d):
    """Stride-2 2x2 transposed conv, channels-last."""
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), conv.weight.to(x.dtype),
                           conv.bias.to(x.dtype), stride=2)
    return y.permute(0, 2, 3, 1)


class MaskDecoder(nn.Module):
    def __init__(self, cfg: SAM2Config):
        super().__init__()
        self.cfg = cfg
        C = cfg.d_model
        self.num_mask_tokens = nmt = 3 + 1     # 3 multimask outputs + 1
        self.obj_score_token = nn.Embedding(1, C)
        self.iou_token = nn.Embedding(1, C)
        self.mask_tokens = nn.Embedding(nmt, C)
        self.transformer = TwoWayTransformer(embedding_dim=C)
        self.output_upscaling = nn.ModuleDict({
            "0": nn.ConvTranspose2d(C, C // 4, 2, stride=2),
            "1": LayerNorm(C // 4, eps=1e-6),
            "3": nn.ConvTranspose2d(C // 4, C // 8, 2, stride=2)})
        self.conv_s0 = nn.Conv2d(C, C // 8, 1)
        self.conv_s1 = nn.Conv2d(C, C // 4, 1)
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLPBlock(C, C, C // 8, 3) for _ in range(nmt))
        self.iou_prediction_head = MLPBlock(
            C, 256, nmt, 3, sigmoid_output=cfg.iou_prediction_use_sigmoid)
        self.pred_obj_score_head = MLPBlock(C, C, 1, 3)

    def forward(self, image_embeddings, image_pe, sparse_prompt_embeddings,
                dense_prompt_embeddings, multimask_output: bool,
                high_res_features=None, training: bool = False):
        """image_embeddings [B, E, E, C]; image_pe [E, E, C]; sparse
        [B, N, C]; dense [B, E, E, C]; high_res_features
        ([B, 4E, 4E, C/8], [B, 2E, 2E, C/4])."""
        cfg = self.cfg
        C = cfg.d_model
        B, E = image_embeddings.shape[0], image_embeddings.shape[1]
        nmt = self.num_mask_tokens
        out_tokens = torch.cat([self.obj_score_token.weight,
                                self.iou_token.weight,
                                self.mask_tokens.weight], dim=0).float()
        tokens = torch.cat([out_tokens.expand(B, -1, -1),
                            sparse_prompt_embeddings.float()], dim=1)
        src = image_embeddings.float() + dense_prompt_embeddings.float()
        hs, src = self.transformer(src, image_pe.float().expand(B, E, E, C),
                                   tokens)
        s = 1   # pred_obj_scores offset
        iou_token_out = hs[:, s]
        mask_tokens_out = hs[:, s + 1: s + 1 + nmt]

        up = self.output_upscaling
        up1 = _conv_transpose_2x(src.reshape(B, E, E, C), up["0"])
        if cfg.use_high_res_features_in_sam:
            feat_s0, feat_s1 = high_res_features
            up1 = up1 + feat_s1.to(up1.dtype)
        up1 = F.gelu(up["1"](up1))
        up2 = _conv_transpose_2x(up1, up["3"])
        if cfg.use_high_res_features_in_sam:
            up2 = up2 + feat_s0.to(up2.dtype)
        upscaled = F.gelu(up2)                               # [B, 4E, 4E, C/8]

        hyper_in = torch.stack([mlp(mask_tokens_out[:, i]) for i, mlp in
                                enumerate(self.output_hypernetworks_mlps)], dim=1)
        masks = torch.einsum("bnc,bhwc->bnhw", hyper_in.float(), upscaled.float())
        iou_pred = self.iou_prediction_head(iou_token_out)
        object_score_logits = self.pred_obj_score_head(hs[:, 0])

        # every candidate of the last call, for the benchmark's check to
        # tell a stability fallback decided the other way from a wrong mask
        self.candidates = (masks, iou_pred)
        if multimask_output:
            out_masks, out_iou = masks[:, 1:], iou_pred[:, 1:]
        elif cfg.dynamic_multimask_via_stability and not training:
            out_masks, out_iou = self._dynamic_multimask(masks, iou_pred)
        else:
            out_masks, out_iou = masks[:, 0:1], iou_pred[:, 0:1]
        if multimask_output and cfg.use_multimask_token_for_obj_ptr:
            sam_tokens_out = mask_tokens_out[:, 1:]
        else:
            sam_tokens_out = mask_tokens_out[:, 0:1]
        return MaskDecoderOutput(out_masks, out_iou, sam_tokens_out,
                                 object_score_logits.float())

    def _stability_scores(self, mask_logits):
        delta = self.cfg.dynamic_multimask_stability_delta
        flat = mask_logits.flatten(-2)
        area_i = (flat > delta).sum(-1).float()
        area_u = (flat > -delta).sum(-1).float()
        return torch.where(area_u > 0, area_i / area_u.clamp(min=1.0), 1.0)

    def _dynamic_multimask(self, all_masks, all_iou):
        """Single mask, falling back to the best multimask candidate when
        the single mask is unstable (mask_decoder.py:138-150)."""
        multi, multi_iou = all_masks[:, 1:], all_iou[:, 1:]
        best = multi_iou.argmax(dim=-1)
        bidx = torch.arange(all_masks.shape[0], device=all_masks.device)
        best_masks = multi[bidx, best][:, None]
        best_iou = multi_iou[bidx, best][:, None]
        single, single_iou = all_masks[:, 0:1], all_iou[:, 0:1]
        stable = (self._stability_scores(single)
                  >= self.cfg.dynamic_multimask_stability_thresh)
        masks = torch.where(stable[..., None, None], single, best_masks)
        iou = torch.where(stable, single_iou, best_iou)
        return masks, iou

"""VideoGLaMM composite (PyTorch port of videoglamm_tpu/models/
videoglamm.py): the inference methods `encode_visual_prefix`,
`encode_sam_features`, `decode_masks`, and the training forward with its
three losses (`forward`, `lm_forward`, `extract_seg`, `ce_loss_fn`,
`sigmoid_ce_loss`, `dice_loss`): loss = ce*1.0 + bce*2.0 + dice*0.5 with
the MASK_IGNORE_INDEX semantics of the reference.

Submodule names: `vision_tower` (InternVideo2), `image_vision_tower`
(CLIP), `mm_projector`, `image_mm_projector`, `llm` (HF Phi-3 names
inside, or HF Llama names with `cfg.llm_type == "llama3_1"`),
`text_hidden_fcs` and `visual_model` (SAM-2), so a reference export maps
onto the port by key prefix (`model.layers.*` ->
`llm.model.layers.*`, `model.visual_model.*` -> `visual_model.*`).
"""
from __future__ import annotations

import re
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import VideoGLaMMConfig
from ..constants import IGNORE_INDEX, MASK_IGNORE_INDEX
from ..ops.resize import resize_bilinear
from .clip_vit import CLIPVisionTower
from .common import cast_compute
from .internvideo2 import InternVideo2Tower
from .multimodal import SplicedBatch, splice_visual_prefix
from .phi3 import Phi3ForCausalLM
from .projectors import TextHiddenFCs, build_vision_projector, build_visual_prefix
from .sam2.sam2_base import SAM2Base


# Submodules that only the tracker and the prompting predictors run (the
# mask-prompt convs: mask prompts). A flax parameter tree initialised
# through the framewise or the training forward holds none of their leaves
# (flax makes a submodule's parameters when it is first called), and the JAX
# model runs those paths with such a tree.
TRACKER_MODULES = ("memory_encoder", "memory_attention", "obj_ptr_proj",
                   "mask_downsample", "sam_prompt_encoder.mask_downscaling")


class SegExtraction(NamedTuple):
    embeds: torch.Tensor     # [R, max_seg, out_dim] (invalid slots zeroed)
    valid: torch.Tensor      # [R, max_seg] bool
    positions: torch.Tensor  # [R, max_seg]


class VideoGLaMMOutput(NamedTuple):
    loss: torch.Tensor
    ce_loss: torch.Tensor
    mask_bce_loss: torch.Tensor
    mask_dice_loss: torch.Tensor
    mask_loss: torch.Tensor
    pred_masks: Optional[torch.Tensor] = None   # [R, max_seg, T_sam, h, w]


def ce_loss_fn(logits, labels, count=None):
    """Causal LM loss: shift, ignore IGNORE_INDEX, mean over the valid
    tokens, in f32 (videoglamm.py:64-74). count: the divisor in place of
    the valid tokens' count (a data-parallel rank's share of a batch is
    divided by the whole batch's count, `ce_target_count`)."""
    logits = logits[:, :-1].float()
    targets = labels[:, 1:]
    valid = targets != IGNORE_INDEX
    tgt = torch.where(valid, targets, 0)
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    nll = torch.where(valid, nll, 0.0)
    if count is None:
        count = valid.sum().clamp(min=1)
    return nll.sum() / count


def ce_target_count(input_ids, text_lens, labels):
    """The number of tokens `ce_loss_fn` averages over once the visual
    prefix is spliced in: it does not depend on the prefix's length, so a
    one-token prefix of width 1 stands in for it."""
    B = input_ids.shape[0]
    zeros = torch.zeros(B, input_ids.shape[1], 1)
    sp = splice_visual_prefix(zeros, input_ids.cpu(), torch.zeros(B, 1, 1),
                              text_lens.cpu(), labels.cpu())
    return int((sp.labels[:, 1:] != IGNORE_INDEX).sum().clamp(min=1))


def sigmoid_ce_loss(pred, gt):
    """Per-mask pixel-mean BCE with the MASK_IGNORE_INDEX regions zeroed but
    the mean still over ALL pixels (videoglamm.py:77-88). pred/gt:
    [..., h, w] -> [...]."""
    p, g = pred.float(), gt.float()
    keep = g != MASK_IGNORE_INDEX
    gc = torch.where(keep, g, 0.0)
    loss = p.clamp(min=0.0) - p * gc + torch.log1p(torch.exp(-p.abs()))
    return torch.where(keep, loss, 0.0).mean(dim=(-2, -1))


def dice_loss(pred, gt, scale: float = 1000.0, eps: float = 1e-6):
    """Per-mask DICE with the ignore regions removed (videoglamm.py:91-101).
    pred/gt: [..., h, w] -> [...]."""
    p, g = torch.sigmoid(pred.float()), gt.float()
    keep = (g != MASK_IGNORE_INDEX).float()
    p, g = p * keep, g * keep
    num = 2.0 * (p / scale * g).sum(dim=(-2, -1))
    den = (p / scale).sum(dim=(-2, -1)) + (g / scale).sum(dim=(-2, -1))
    return 1.0 - (num + eps) / (den + eps)


class VideoGLaMM(nn.Module):
    """`remat_llm`, `lora_rank` and `lora_alpha` are the training options of
    the LLM (videoglamm.py:107-109). `quant_llm_int8` / `quant_llm_int4`
    build the LLM in weight-only quantised serving form; `quant_kv_int8`
    makes generation use the int8 KV cache (read by inference/generate.py)
    (videoglamm.py:110-132). `cfg.llm_type` selects the base decoder
    (videoglamm.py:119-138); the Llama-3.1 base has neither LoRA nor
    quantised projections, and asking for them raises (the JAX module
    drops those options without a word). `exact_f32` is True for a model
    whose compute dtype is f32 (`models.common.set_exact_f32`, called by
    `build_inference` and `build_training`): its attention takes the
    full-precision f32 routes on the card, and the serving and training
    entry points run it with TF32 off."""

    exact_f32 = False

    def __init__(self, cfg: VideoGLaMMConfig, *, remat_llm: bool = False,
                 lora_rank: int = 0, lora_alpha: float = 16.0,
                 quant_llm_int8: bool = False,
                 quant_llm_int4: bool = False, quant_kv_int8: bool = False):
        super().__init__()
        if cfg.llm_type != "phi3":
            raise ValueError(f"llm_type {cfg.llm_type!r}: the reference "
                             "holds Phi-3 only")
        self.cfg = cfg
        hidden = cfg.llm_config.hidden_size
        self.vision_tower = InternVideo2Tower(cfg.internvideo)
        self.image_vision_tower = CLIPVisionTower(cfg.clip)
        self.mm_projector = build_vision_projector(
            cfg.mm_projector_type, cfg.internvideo.embed_dim, hidden)
        self.image_mm_projector = build_vision_projector(
            cfg.mm_projector_type, cfg.clip.hidden_size, hidden)
        self.quant_kv_int8 = quant_kv_int8
        self.llm = Phi3ForCausalLM(cfg.llm, extra_vocab=1,
                                   quant_int8=quant_llm_int8,
                                   quant_int4=quant_llm_int4,
                                   remat=remat_llm, lora_rank=lora_rank,
                                   lora_alpha=lora_alpha)
        self.text_hidden_fcs = nn.ModuleList([TextHiddenFCs(hidden, cfg.out_dim)])
        self.visual_model = SAM2Base(cfg.sam2)

    def load_weights(self, state_dict, allow_missing=None):
        """`load_state_dict`, strict but for two things: a tracker submodule
        (`TRACKER_MODULES`) may be absent as a whole, in which case it keeps
        its initial values, and keys that the compiled regex `allow_missing`
        matches may be absent. Anything else missing or unexpected raises."""
        res = self.load_state_dict(state_dict, strict=False)
        missing = [k for k in res.missing_keys
                   if not (allow_missing is not None and allow_missing.search(k))]
        own = list(self.state_dict())
        for name in TRACKER_MODULES:
            pre = f"visual_model.{name}."
            if sum(k.startswith(pre) for k in missing) \
                    == sum(k.startswith(pre) for k in own):
                missing = [k for k in missing if not k.startswith(pre)]
        if missing or res.unexpected_keys:
            raise ValueError(f"state_dict does not fit: missing {missing}, "
                             f"unexpected {res.unexpected_keys}")
        return self

    def to_compute_dtype(self, dtype, keep_masters: bool = False):
        """Store the compute weights in `dtype` (bf16). The SAM prompt
        encoder, mask decoder, memory encoder, memory attention,
        `obj_ptr_proj`, the memory parameters and text_hidden_fcs stay f32,
        as in the JAX model, except the skip projections conv_s0/s1, which
        run in the image-encoder dtype. keep_masters (training): the LLM's trainable
        weights (LoRA, embed_tokens, lm_head) stay f32 masters and are cast
        at use; a bf16 master would drop updates of size lr * g."""
        for m in (self.vision_tower, self.image_vision_tower, self.mm_projector,
                  self.image_mm_projector, self.visual_model.image_encoder):
            cast_compute(m, dtype)
        keep = re.compile(r"lora_[ab]|embed_tokens|lm_head") if keep_masters \
            else None
        cast_compute(self.llm, dtype, keep)
        self.llm.act_dtype = dtype if keep_masters else None
        dec = self.visual_model.sam_mask_decoder
        dec.conv_s0.to(dtype)
        dec.conv_s1.to(dtype)
        return self

    def encode_visual_prefix(self, frames, context_images):
        """frames [Bv, T, 224, 224, 3]; context [Bv, T, 336, 336, 3] ->
        [Bv, V, H] visual prefix."""
        cfg = self.cfg
        Bv, T = frames.shape[:2]
        ck = cfg.chunk_size
        assert T % ck == 0, (T, ck)
        L = cfg.internvideo.tokens_per_frame
        vid = self.vision_tower(frames.reshape(Bv * (T // ck), ck,
                                               *frames.shape[2:]))
        vid = vid.reshape(Bv, T, L, vid.shape[-1])
        ctx = self.image_vision_tower(
            context_images.reshape(Bv * T, *context_images.shape[2:]))
        ctx = ctx.reshape(Bv, T, ctx.shape[1], ctx.shape[2])
        return build_visual_prefix(self.mm_projector(vid),
                                   self.image_mm_projector(ctx), chunk_size=ck,
                                   video_pool=cfg.video_pool,
                                   context_pool=cfg.context_pool)

    def encode_sam_features(self, frames_sam):
        """frames_sam [Bv, T_sam, S, S, 3] -> (feats with a leading
        [Bv, T_sam], pos). All frames run as one batch."""
        Bv, T = frames_sam.shape[:2]
        feats, pos = self.visual_model.forward_image(
            frames_sam.reshape(Bv * T, *frames_sam.shape[2:]))
        return [f.reshape(Bv, T, *f.shape[1:]) for f in feats], pos

    def lm_forward(self, visual_prefix, input_ids, text_lens, labels=None,
                   video_idx=None):
        """Splice the per-row visual prefixes (gathered through video_idx)
        and run the decoder -> (logits, hidden, SplicedBatch)
        (videoglamm.py:213-223)."""
        if video_idx is not None:
            visual_prefix = visual_prefix[video_idx]
        sp = splice_visual_prefix(self.llm.embed(input_ids), input_ids,
                                  visual_prefix, text_lens, labels)
        logits, hidden, _ = self.llm(sp.embeds, sp.positions, sp.attn_lens)
        return logits, hidden, sp

    def extract_seg(self, hidden, sp: SplicedBatch) -> SegExtraction:
        """First max_seg [SEG] occurrences per row -> prompt embeddings,
        invalid slots zeroed (videoglamm.py:226-240)."""
        cfg = self.cfg
        R, S = sp.token_ids.shape
        pos = torch.arange(S, device=hidden.device)[None, :]
        is_seg = (sp.token_ids == cfg.seg_token_idx) & (pos < sp.attn_lens[:, None])
        key = torch.where(is_seg, pos, S + pos)
        idx = key.argsort(dim=1, stable=True)[:, :cfg.max_seg_tokens]
        valid = torch.gather(is_seg, 1, idx)
        h = torch.gather(hidden, 1, idx[..., None].expand(-1, -1, hidden.shape[-1]))
        emb = self.text_hidden_fcs[0](h.float())
        emb = torch.where(valid[..., None], emb, 0.0)
        return SegExtraction(embeds=emb, valid=valid, positions=idx)

    def decode_masks(self, sam_feats, seg: SegExtraction, video_idx,
                     training: bool = False):
        """One batched decode over R*max_seg*T_sam prompts -> low-res mask
        logits [R, max_seg, T_sam, 4E, 4E]. training=True turns the
        stability fallback of the single-mask output off
        (mask_decoder.py:113)."""
        ms = self.cfg.max_seg_tokens
        R = seg.embeds.shape[0]
        T = sam_feats[0].shape[1]
        C = seg.embeds.shape[-1]
        sparse = seg.embeds[:, :, None, None, :].expand(R, ms, T, 1, C)
        sparse = sparse.reshape(R * ms * T, 1, C)

        def expand(f):
            f = f[video_idx]
            f = f[:, None].expand(R, ms, *f.shape[1:])
            return f.reshape(R * ms * T, *f.shape[3:])

        s0, s1, embed = (expand(f) for f in sam_feats)
        sam = self.visual_model
        sparse_pe, dense_pe = sam.sam_prompt_encoder(sparse)
        dec = sam.sam_mask_decoder(embed, sam.sam_prompt_encoder.get_dense_pe(),
                                   sparse_pe, dense_pe, multimask_output=False,
                                   high_res_features=(s0, s1),
                                   training=training)
        m = dec.masks[:, 0]
        return m.reshape(R, ms, T, m.shape[-2], m.shape[-1])

    def forward(self, frames, context_images, frames_sam, input_ids, text_lens,
                labels, video_idx, gt_masks, freeze_towers: bool = True,
                return_pred_masks: bool = False, ce_norm=None,
                mask_norm=None) -> VideoGLaMMOutput:
        """Training forward (videoglamm.py:293-355).

        frames [Bv, T, 224, 224, 3]; context_images [Bv, T, 336, 336, 3];
        frames_sam [Bv, T_sam, S, S, 3]; input_ids [R, S_text] with one
        IMAGE_TOKEN_INDEX placeholder a row; text_lens [R]; labels
        [R, S_text]; video_idx [R] row -> video slot; gt_masks
        [R, max_seg, T_sam, h, w] binary with MASK_IGNORE_INDEX padding.

        freeze_towers=True: the towers, the projectors and the SAM image
        encoder run without a gradient (the stop_gradient of
        videoglamm.py:321-323). freeze_towers=False runs them under the
        gradient, as JAX does without the stop_gradient: the gradient
        reaches every tower leaf that asks for one (the leaves that train
        are the optimizer's patterns, `training.make_optimizer`). Their
        kernels carry the JAX package's backward rules: K1 in BSHD and
        window modes and K7 / K8 recompute through their plain twins, the
        Hiera window block recomputes through `_fused_block_ref`, K1 flash
        takes K6, and K3 recomputes through its twin.

        ce_norm, mask_norm: the divisors of the CE loss (valid tokens) and
        of the mask losses (R * max_seg * T_sam) in place of this batch's
        own; a data-parallel rank passes the whole batch's, so that the
        ranks' losses add up to the whole batch's loss."""
        cfg = self.cfg
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not freeze_towers):
            visual = self.encode_visual_prefix(frames, context_images)
            sam_feats, _ = self.encode_sam_features(frames_sam)

        logits, hidden, sp = self.lm_forward(visual, input_ids, text_lens,
                                             labels, video_idx)
        ce = ce_loss_fn(logits, sp.labels, ce_norm)

        seg = self.extract_seg(hidden, sp)
        pred = self.decode_masks(sam_feats, seg, video_idx, training=True)

        # upsample the predictions to the ground-truth resolution
        R, ms, T = pred.shape[:3]
        h, w = gt_masks.shape[-2:]
        if tuple(pred.shape[-2:]) != (h, w):
            p = pred.reshape(R * ms * T, *pred.shape[3:])[..., None]
            pred = resize_bilinear(p, (h, w))[..., 0].reshape(R, ms, T, h, w)

        # every padded slot counts in num_masks, as in the reference
        num_masks = R * ms * T if mask_norm is None else mask_norm
        bce = sigmoid_ce_loss(pred, gt_masks).sum() / (num_masks + 1e-8)
        dce = dice_loss(pred, gt_masks).sum() / (num_masks + 1e-8)

        ce_w = cfg.ce_loss_weight * ce
        bce_w = cfg.bce_loss_weight * bce
        dice_w = cfg.dice_loss_weight * dce
        mask_loss = bce_w + dice_w
        return VideoGLaMMOutput(
            loss=ce_w + mask_loss, ce_loss=ce_w, mask_bce_loss=bce_w,
            mask_dice_loss=dice_w, mask_loss=mask_loss,
            pred_masks=pred if return_pred_masks else None)

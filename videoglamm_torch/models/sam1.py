"""SAM-1 (ViT-H), the v1 / v1_itm pixel decoder (PyTorch port of
videoglamm_tpu/models/sam1.py).

- image encoder: 16x16 patches, a learned absolute position embedding, a
  plain ViT whose blocks attend inside 14x14 windows (the 64x64 grid is
  zero-padded to 70x70) but for the global blocks, with the decomposed
  relative-position bias of MViTv2 added after the logit scale; a neck of
  a 1x1 conv, LayerNorm, a 3x3 conv and LayerNorm down to 256 channels;
- the SAM prompt encoder with the text-embeds hook, shared with SAM-2;
- a mask decoder with an iou token and 4 mask tokens (no object score, no
  high-res skips) and, with `cfg.with_itm`, the VideoGLaMM ITM head: the
  next frame's track tokens are the mask tokens plus a ReLU'd two-layer
  MLP of them, and track tokens that come in join the output tokens;
- `track_frames`: one encode of every frame, then the decode of frame t
  fed frame t-1's track tokens (the JAX module's `nn.scan` is a loop).

The encoder runs in the compute dtype (erf GELU in f32, tanh below, as
`gelu_exact` decides); its biased attention is plain in both packages
(`dot_product_attention` with `bias=`). The bias is computed in f32. The
decoder runs in f32. Every LayerNorm goes through `layer_norm` (K3 on the
card where its dispatch rule takes the shape). Parameter names are the
keys `import_sam1` reads (videoglamm_tpu/io/import_torch.py:419-497), so
a reference SAM-1 state dict loads with `load_state_dict`.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import SAM1Config, SAM2Config
from ..ops.attention import dot_product_attention
from .common import LayerNorm, MLPBlock, gelu_exact, patchify_conv
from .sam2.fpn import conv1x1_nhwc
from .sam2.hiera import window_partition, window_unpartition
from .sam2.mask_decoder import _conv_transpose_2x
from .sam2.memory import _conv_nhwc
from .sam2.prompt_encoder import PromptEncoder
from .sam2.transformer import TwoWayTransformer

PATCH = 16


def _rel_pos_bias(q, rel_pos_h, rel_pos_w, hw: Tuple[int, int]):
    """Decomposed relative-position bias (sam1.py:39-59). q: [B, nh, S, hd]
    with S == h*w -> f32 [B, nh, S, S]; key (i, j) of query (y, x) gets
    q . Rh[y - i] + q . Rw[x - j]."""
    h, w = hw

    def gather(rel, size):
        r = torch.arange(size, device=rel.device)
        return rel[r[:, None] - r[None, :] + size - 1].float()   # [size, size, hd]

    B, nh, S, hd = q.shape
    rq = q.reshape(B, nh, h, w, hd).float()
    rel_h = torch.einsum("bnhwc,hkc->bnhwk", rq, gather(rel_pos_h, h))
    rel_w = torch.einsum("bnhwc,wkc->bnhwk", rq, gather(rel_pos_w, w))
    return (rel_h[..., :, None] + rel_w[..., None, :]).reshape(B, nh, S, S)


class LinMlp(nn.Module):
    """segment_anything's MLPBlock: `lin1`, the activation, `lin2`."""

    def __init__(self, dim: int, hidden_dim: int, activation=gelu_exact):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden_dim)
        self.lin2 = nn.Linear(hidden_dim, dim)
        self.activation = activation

    def forward(self, x):
        return self.lin2(self.activation(self.lin1(x)))


class SAM1Attention(nn.Module):
    """Attention over a [B, H, W, C] grid (a window, or the whole image)
    with the relative-position bias of that grid's size."""

    def __init__(self, dim: int, num_heads: int, input_size: Tuple[int, int]):
        super().__init__()
        self.num_heads = num_heads
        hd = dim // num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, hd))

    def forward(self, x):
        B, H, W, D = x.shape
        nh = self.num_heads
        qkv = self.qkv(x).reshape(B, H * W, 3, nh, D // nh)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)          # [B, nh, S, hd]
        bias = _rel_pos_bias(q, self.rel_pos_h, self.rel_pos_w, (H, W))
        o = dot_product_attention(q, k, v, bias=bias)
        return self.proj(o.transpose(1, 2).reshape(B, H, W, D))


class SAM1Block(nn.Module):
    """Pre-norm ViT block; window_size 0 attends over the whole grid."""

    def __init__(self, dim: int, num_heads: int, window_size: int, grid: int):
        super().__init__()
        self.window_size = window_size
        size = window_size if window_size > 0 else grid
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = SAM1Attention(dim, num_heads, (size, size))
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = LinMlp(dim, 4 * dim)

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        H, W = x.shape[1], x.shape[2]
        ws = self.window_size
        if ws > 0:
            x, pad_hw = window_partition(x, ws)
        x = self.attn(x)
        if ws > 0:
            x = window_unpartition(x, ws, pad_hw, (H, W))
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class _PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, PATCH, stride=PATCH)


class SAM1ImageEncoder(nn.Module):
    def __init__(self, cfg: SAM1Config):
        super().__init__()
        self.cfg = cfg
        D, C = cfg.encoder_embed_dim, cfg.prompt_embed_dim
        g = cfg.image_size // PATCH
        self.patch_embed = _PatchEmbed(D)
        self.pos_embed = nn.Parameter(torch.zeros(1, g, g, D))
        self.blocks = nn.ModuleList(
            SAM1Block(D, cfg.encoder_num_heads,
                      0 if i in cfg.encoder_global_attn_indexes else cfg.window_size, g)
            for i in range(cfg.encoder_depth))
        self.neck = nn.ModuleList([nn.Conv2d(D, C, 1, bias=False),
                                   LayerNorm(C, eps=1e-6),
                                   nn.Conv2d(C, C, 3, padding=1, bias=False),
                                   LayerNorm(C, eps=1e-6)])

    def forward(self, images):
        """images [B, S, S, 3] (normalised) -> [B, S/16, S/16, C] in the
        encoder's weight dtype."""
        B = images.shape[0]
        g = self.cfg.image_size // PATCH
        proj = self.patch_embed.proj
        x = patchify_conv(images.to(proj.weight.dtype), proj.weight, proj.bias,
                          PATCH).reshape(B, g, g, -1)
        x = x + self.pos_embed.to(x.dtype)
        for blk in self.blocks:
            x = blk(x)
        neck = self.neck
        x = neck[1](conv1x1_nhwc(x, neck[0]))
        return neck[3](_conv_nhwc(x, neck[2]))


class SAM1DecoderOutput(NamedTuple):
    masks: torch.Tensor            # [B, M, 4E, 4E]
    iou_pred: torch.Tensor         # [B, M]
    track_token_out: torch.Tensor  # [B, num_mask_tokens, C]


class SAM1TwoWayTransformer(TwoWayTransformer):
    """The SAM two-way transformer under segment_anything's names: each
    block's MLP is `mlp.lin1` / `mlp.lin2`."""

    def __init__(self, embedding_dim: int):
        super().__init__(embedding_dim)
        for layer in self.layers:
            layer.mlp = LinMlp(embedding_dim, 2048, activation=F.relu)


class SAM1MaskDecoder(nn.Module):
    """CustomMaskDecoder with ITM (sam1.py:158-227); without `with_itm` the
    plain SAM decoder, whose track tokens are the mask tokens."""

    def __init__(self, cfg: SAM1Config):
        super().__init__()
        self.cfg = cfg
        C = cfg.prompt_embed_dim
        self.num_mask_tokens = nmt = 3 + 1     # 3 multimask outputs + 1
        self.iou_token = nn.Embedding(1, C)
        self.mask_tokens = nn.Embedding(nmt, C)
        self.transformer = SAM1TwoWayTransformer(C)
        self.output_upscaling = nn.ModuleDict({
            "0": nn.ConvTranspose2d(C, C // 4, 2, stride=2),
            "1": LayerNorm(C // 4, eps=1e-6),
            "3": nn.ConvTranspose2d(C // 4, C // 8, 2, stride=2)})
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLPBlock(C, C, C // 8, 3) for _ in range(nmt))
        self.iou_prediction_head = MLPBlock(C, 256, nmt, 3)
        if cfg.with_itm:
            self.itm_head = nn.ModuleDict({"mlp1": nn.Sequential(nn.Linear(C, C)),
                                           "mlp2": nn.Sequential(nn.Linear(C, C))})

    def forward(self, image_embeddings, image_pe, sparse_prompt_embeddings,
                dense_prompt_embeddings, multimask_output: bool,
                track_token_in=None) -> SAM1DecoderOutput:
        """image_embeddings [B, E, E, C]; image_pe [E, E, C]; sparse
        [B, N, C]; dense [B, E, E, C]; track_token_in [B, 4, C] or None."""
        C = self.cfg.prompt_embed_dim
        B, E = image_embeddings.shape[0], image_embeddings.shape[1]
        nmt = self.num_mask_tokens
        out_tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight],
                               dim=0).float().expand(B, -1, -1)
        if track_token_in is not None:
            out_tokens = torch.cat([out_tokens, track_token_in.float()], dim=1)
        tokens = torch.cat([out_tokens, sparse_prompt_embeddings.float()], dim=1)
        src = image_embeddings.float() + dense_prompt_embeddings.float()
        hs, src = self.transformer(src, image_pe.float().expand(B, E, E, C), tokens)
        iou_token_out = hs[:, 0]
        mask_tokens_out = hs[:, 1:1 + nmt]
        if self.cfg.with_itm:
            itm = self.itm_head
            h = itm["mlp2"][0](F.relu(itm["mlp1"][0](mask_tokens_out)))
            track_token_out = mask_tokens_out + F.relu(h)
        else:
            track_token_out = mask_tokens_out

        up = self.output_upscaling
        up1 = F.gelu(up["1"](_conv_transpose_2x(src.reshape(B, E, E, C), up["0"])))
        upscaled = F.gelu(_conv_transpose_2x(up1, up["3"]))      # [B, 4E, 4E, C/8]
        hyper = torch.stack([mlp(mask_tokens_out[:, i]) for i, mlp in
                             enumerate(self.output_hypernetworks_mlps)], dim=1)
        masks = torch.einsum("bnc,bhwc->bnhw", hyper.float(), upscaled.float())
        iou_pred = self.iou_prediction_head(iou_token_out)
        sl = slice(1, None) if multimask_output else slice(0, 1)
        return SAM1DecoderOutput(masks[:, sl], iou_pred[:, sl], track_token_out)


class SAM1(nn.Module):
    """Encoder, prompt encoder (with the text hook) and decoder."""

    def __init__(self, cfg: SAM1Config):
        super().__init__()
        self.cfg = cfg
        self.image_encoder = SAM1ImageEncoder(cfg)
        # the SAM-1 prompt encoder is the SAM-2 one at SAM-1's sizes
        self.prompt_encoder = PromptEncoder(
            SAM2Config(image_size=cfg.image_size, d_model=cfg.prompt_embed_dim))
        self.mask_decoder = SAM1MaskDecoder(cfg)

    def forward_image(self, images):
        return self.image_encoder(images)

    def decode(self, embeddings, text_embeds, track_token_in=None,
               multimask_output: bool = False) -> SAM1DecoderOutput:
        sparse, dense = self.prompt_encoder(text_embeds=text_embeds)
        return self.mask_decoder(embeddings, self.prompt_encoder.get_dense_pe(),
                                 sparse, dense, multimask_output, track_token_in)

    def forward(self, images, text_embeds):
        return self.decode(self.forward_image(images), text_embeds)

    def track_frames(self, frames, text_embeds):
        """Per-frame decoding with the ITM track-token recurrence
        (sam1.py:260-290). frames [T, S, S, 3]; text_embeds [B, N, C], one
        object a row -> mask logits [B, T, 4E, 4E]. Every frame is encoded
        in one forward; frame t's decode takes frame t-1's track tokens
        (with `with_itm`)."""
        B = text_embeds.shape[0]
        embs = self.forward_image(frames)                    # [T, E, E, C]
        masks, track = [], None
        for emb in embs:
            dec = self.decode(emb[None].expand(B, *emb.shape), text_embeds, track)
            track = dec.track_token_out if self.cfg.with_itm else None
            masks.append(dec.masks[:, 0])
        return torch.stack(masks, dim=1)

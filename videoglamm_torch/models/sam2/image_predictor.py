"""SAM-2 image predictor: prompted segmentation of single images and of
batches (PyTorch port of videoglamm_tpu/models/sam2/image_predictor.py).

- `set_image` / `set_image_batch`: a direct square resize to the model's
  image size (the PIL triangle filter, as two matrix products) and the SAM
  normalisation, one image-encoder forward for all images of a batch, and
  `no_mem_embed` added to the top feature level (directly_add_no_mem_embed);
- `predict` / `predict_batch`: point coordinates and boxes in pixels of the
  original image are scaled into model space, a box becomes two corner
  points labelled 2 and 3 ahead of the clicks, and low-res logits of a
  previous round feed back as the mask prompt. The decoder returns every
  hypothesis mask with its IoU prediction, without the video path's
  object-score gating or best-mask choice;
- postprocessing: hole and sprinkle filling of the low-res logits through
  `ops/connected_components.py`, a bilinear resize to the original size,
  the threshold; low-res logits come back clamped to +-32 for reuse.

The JAX predictor compiles one program per prompt layout; here the modules
are called directly. Masks, IoUs and low-res logits come back as numpy
arrays, as the JAX predictor returns them.
"""
from __future__ import annotations

import functools
from typing import List, Optional

import numpy as np
import torch

from ...constants import SAM_PIXEL_MEAN, SAM_PIXEL_STD
from ...ops.connected_components import postprocess_mask_scores
from ...ops.preprocess import _sep
from ...ops.resize import pil_resize_matrix, resize_bilinear
from .sam2_base import SAM2Base, model_device


@functools.lru_cache(maxsize=64)
def _square_mats(H: int, W: int, size: int, device: torch.device):
    """Direct square resize (torchvision Resize((size, size)), antialiased
    bilinear: the PIL triangle kernel), device copies."""
    return tuple(torch.from_numpy(pil_resize_matrix(n, size, "bilinear")).to(device)
                 for n in (H, W))


def preprocess_image_square(image, size: int, device=None):
    """[H, W, 3] uint8 or float in 0..255 (numpy or torch) -> f32
    [size, size, 3] SAM-normalised (SAM2Transforms.__call__,
    image_predictor.py:56) on `device` (the image's own by default)."""
    x = torch.as_tensor(image)
    if device is not None:
        x = x.to(device)
    H, W = x.shape[-3], x.shape[-2]
    y = _sep(x.float(), *_square_mats(int(H), int(W), size, x.device))
    mean = torch.tensor(SAM_PIXEL_MEAN, device=x.device)
    std = torch.tensor(SAM_PIXEL_STD, device=x.device)
    return (y - mean) / std


class SAM2ImagePredictor:
    """Stateful single- or batch-image prompting session over a built
    `SAM2Base` (`inference.pipeline.build_sam2`): set_image /
    set_image_batch -> predict / predict_batch -> (masks at the original
    resolution, IoU predictions, low-res logits reusable as the next
    round's mask_input), reset_predictor and get_image_embedding."""

    def __init__(self, model: SAM2Base, mask_threshold: float = 0.0,
                 max_hole_area: float = 0.0, max_sprinkle_area: float = 0.0):
        self.model = model
        self.mask_threshold = float(mask_threshold)
        self.max_hole_area = float(max_hole_area)
        self.max_sprinkle_area = float(max_sprinkle_area)
        self.reset_predictor()

    def reset_predictor(self) -> None:
        """Drop the set image(s) and their embeddings."""
        self._features = None
        self._orig_hw: List = []
        self._is_image_set = False
        self._is_batch = False

    @torch.no_grad()
    def _encode(self, x):
        m = self.model
        feats, _ = m.forward_image(x)
        top = feats[2] + m.no_mem_embed.reshape(1, 1, 1, -1).to(feats[2].dtype)
        return feats[0], feats[1], top

    def set_image(self, image) -> None:
        """image: [H, W, 3] RGB in 0..255, numpy or torch (uint8 or float)."""
        self.reset_predictor()
        if not torch.is_tensor(image):
            image = np.asarray(image)
        assert image.ndim == 3 and image.shape[-1] == 3, image.shape
        self._orig_hw = [tuple(image.shape[:2])]
        x = preprocess_image_square(image, self.model.cfg.image_size,
                                    model_device(self.model))
        self._features = self._encode(x[None])
        self._is_image_set = True

    def set_image_batch(self, image_list) -> None:
        """Images of any sizes, encoded as ONE batch."""
        self.reset_predictor()
        image_list = [im if torch.is_tensor(im) else np.asarray(im)
                      for im in image_list]
        self._orig_hw = [tuple(im.shape[:2]) for im in image_list]
        size, dev = self.model.cfg.image_size, model_device(self.model)
        x = torch.stack([preprocess_image_square(im, size, dev)
                         for im in image_list])
        self._features = self._encode(x)
        self._is_image_set = True
        self._is_batch = True

    def get_image_embedding(self, channels_first: bool = False):
        """Top-level image embedding, channels-last [B, E, E, C] (the JAX
        predictor's layout), or [B, C, E, E] with channels_first=True (the
        reference's)."""
        assert self._is_image_set, "call set_image first"
        emb = self._features[2]
        return emb.permute(0, 3, 1, 2) if channels_first else emb

    def _prep_prompts(self, point_coords, point_labels, box, mask_input,
                      normalize_coords: bool, img_idx: int):
        """Prompt normalisation on the host (image_predictor.py:141-185):
        pixel coordinates of the original image into model space, box
        corners ahead of the points; the mask input [B, 1, h, w] (or
        [1, h, w]) to [B, h, w, 1]."""
        size = self.model.cfg.image_size
        H, W = self._orig_hw[img_idx]
        dev = model_device(self.model)
        coords_parts, label_parts = [], []
        if box is not None:
            b = np.asarray(box, np.float32).reshape(-1, 2, 2)
            if normalize_coords:
                b = b / np.asarray([W, H], np.float32)
            coords_parts.append(b * size)
            label_parts.append(np.tile(np.asarray([[2, 3]], np.int32),
                                       (b.shape[0], 1)))
        if point_coords is not None:
            assert point_labels is not None, \
                "point_labels must be supplied with point_coords"
            c = np.asarray(point_coords, np.float32)
            lab = np.asarray(point_labels, np.int32)
            if c.ndim == 2:
                c, lab = c[None], lab[None]
            if normalize_coords:
                c = c / np.asarray([W, H], np.float32)
            coords_parts.append(c * size)
            label_parts.append(lab)
        coords = labels = None
        if coords_parts:
            B = max(p.shape[0] for p in coords_parts)
            coords = np.concatenate([np.broadcast_to(p, (B,) + p.shape[1:])
                                     for p in coords_parts], axis=1)
            labels = np.concatenate([np.broadcast_to(p, (B,) + p.shape[1:])
                                     for p in label_parts], axis=1)
            coords = torch.from_numpy(coords).to(dev)
            labels = torch.from_numpy(labels).to(dev)
        mask_in = None
        if mask_input is not None:
            m = torch.as_tensor(np.asarray(mask_input, np.float32))
            if m.ndim == 3:                              # [1, h, w]
                m = m[None]
            mask_in = m.permute(0, 2, 3, 1).to(dev)
        return coords, labels, mask_in

    def _decode(self, h0, h1, embed, coords, labels, mask_in, multimask: bool):
        """One encoded image, a batch of prompts (image_predictor.py:186-216):
        the image's features are expanded to the prompts' batch, not
        copied."""
        m = self.model
        B = (coords.shape[0] if coords is not None else
             (mask_in.shape[0] if mask_in is not None else 1))
        sparse, dense = m.sam_prompt_encoder(
            points=(coords, labels) if coords is not None else None,
            masks=mask_in)
        dec = m.sam_mask_decoder(
            embed.expand(B, *embed.shape[1:]), m.sam_prompt_encoder.get_dense_pe(),
            sparse, dense, multimask_output=multimask,
            high_res_features=(h0.expand(B, *h0.shape[1:]),
                               h1.expand(B, *h1.shape[1:])))
        return dec.masks.float(), dec.iou_pred.float()

    @torch.no_grad()
    def _predict_idx(self, img_idx, point_coords, point_labels, box,
                     mask_input, multimask_output, return_logits,
                     normalize_coords):
        assert self._is_image_set, \
            "an image must be set with set_image(...) before prediction"
        coords, labels, mask_in = self._prep_prompts(
            point_coords, point_labels, box, mask_input, normalize_coords,
            img_idx)
        h0, h1, embed = (f[img_idx][None] for f in self._features)
        low_res, ious = self._decode(h0, h1, embed, coords, labels, mask_in,
                                     bool(multimask_output))
        B, M, h, w = low_res.shape
        filled = low_res.reshape(B * M, h, w)
        if self.max_hole_area > 0 or self.max_sprinkle_area > 0:
            filled = postprocess_mask_scores(
                filled, max_hole_area=self.max_hole_area,
                max_sprinkle_area=self.max_sprinkle_area,
                mask_threshold=self.mask_threshold)
        H, W = self._orig_hw[img_idx]
        masks = resize_bilinear(filled[..., None], (H, W))[..., 0]
        masks = masks.reshape(B, M, H, W)
        if not return_logits:
            masks = masks > self.mask_threshold
        return (masks.cpu().numpy(), ious.cpu().numpy(),
                low_res.clamp(-32.0, 32.0).cpu().numpy())

    def predict(self, point_coords: Optional[np.ndarray] = None,
                point_labels: Optional[np.ndarray] = None,
                box: Optional[np.ndarray] = None,
                mask_input: Optional[np.ndarray] = None,
                multimask_output: bool = True, return_logits: bool = False,
                normalize_coords: bool = True):
        """Masks for the set image: (masks [C, H, W], iou_predictions [C],
        low_res_logits [C, 4E, 4E]), C = 3 with multimask_output, else 1;
        several boxes keep a leading [B]."""
        masks, ious, low = self._predict_idx(
            -1, point_coords, point_labels, box, mask_input,
            multimask_output, return_logits, normalize_coords)
        if masks.shape[0] == 1:
            masks, ious, low = masks[0], ious[0], low[0]
        return masks, ious, low

    def predict_batch(self, point_coords_batch=None, point_labels_batch=None,
                      box_batch=None, mask_input_batch=None,
                      multimask_output: bool = True,
                      return_logits: bool = False,
                      normalize_coords: bool = True):
        """Per-image prompts over a set_image_batch session; lists of
        `predict`'s three outputs."""
        assert self._is_batch, "use set_image_batch for batched prediction"

        def pick(lst, i):
            return None if lst is None else lst[i]

        all_masks, all_ious, all_lows = [], [], []
        for i in range(len(self._orig_hw)):
            masks, ious, low = self._predict_idx(
                i, pick(point_coords_batch, i), pick(point_labels_batch, i),
                pick(box_batch, i), pick(mask_input_batch, i),
                multimask_output, return_logits, normalize_coords)
            if masks.shape[0] == 1:
                masks, ious, low = masks[0], ious[0], low[0]
            all_masks.append(masks)
            all_ious.append(ious)
            all_lows.append(low)
        return all_masks, all_ious, all_lows

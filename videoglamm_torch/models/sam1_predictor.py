"""SAM-1 prompted image predictor and automatic mask generator (PyTorch
port of videoglamm_tpu/models/sam1_predictor.py).

- `set_image`: ResizeLongestSide (the longest side scaled to the model
  resolution, the PIL triangle filter as two matrix products), the SAM
  normalisation, then zero padding at the bottom and right to the square
  model resolution;
- `predict`: pixel prompts are scaled per axis by the rounded resized
  shape over the original one (not SAM-2's square normalisation); a box
  goes through the prompt encoder's corner embeddings (no padding point is
  appended with a box); mask_input is the dense prompt at 4x the embedding
  resolution;
- postprocessing: low-res logits -> bilinear to the square model
  resolution -> the valid (newh, neww) region -> bilinear to the original
  size;
- the generator is the SAM-2 one over its hooks, without m2m, and runs
  `postprocess_small_regions` inside `_generate_masks` when
  min_mask_region_area is set. As the SAM-2 generator, it filters on the
  card and brings back only the kept masks' run boundaries.

The modules are called directly where the JAX predictor compiles one
program per prompt layout. Masks, IoUs and low-res logits come back as
numpy arrays.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import SAM_PIXEL_MEAN, SAM_PIXEL_STD
from ..ops.preprocess import _sep
from ..ops.resize import pil_resize_matrix, resize_bilinear
from .sam1 import SAM1
from .sam2.amg import SAM2AutomaticMaskGenerator, score_masks
from .sam2.sam2_base import model_device


def preprocess_shape(h: int, w: int, long_side: int) -> Tuple[int, int]:
    """ResizeLongestSide.get_preprocess_shape (sam1_predictor.py:44-47)."""
    scale = long_side / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


@functools.lru_cache(maxsize=64)
def _longest_mats(H: int, W: int, size: int, device: torch.device):
    nh, nw = preprocess_shape(H, W, size)
    return (torch.from_numpy(pil_resize_matrix(H, nh, "bilinear")).to(device),
            torch.from_numpy(pil_resize_matrix(W, nw, "bilinear")).to(device),
            (nh, nw))


def preprocess_image_longest(image, size: int, device=None):
    """[H, W, 3] uint8 or float in 0..255 (numpy or torch) -> (f32
    [size, size, 3] SAM-normalised, zero-padded at the bottom and right,
    on `device` (the image's own by default); (newh, neww))."""
    x = torch.as_tensor(image)
    if device is not None:
        x = x.to(device)
    H, W = x.shape[-3], x.shape[-2]
    mh, mw, (nh, nw) = _longest_mats(int(H), int(W), size, x.device)
    y = _sep(x.float(), mh, mw)
    mean = torch.tensor(SAM_PIXEL_MEAN, device=x.device)
    std = torch.tensor(SAM_PIXEL_STD, device=x.device)
    y = F.pad((y - mean) / std, (0, 0, 0, size - nw, 0, size - nh))
    return y, (nh, nw)


class SAM1ImagePredictor:
    """Stateful single-image prompting session over a built `SAM1`
    (`inference.pipeline.build_sam1`): set_image -> predict -> reset_image,
    as the reference SamPredictor."""

    def __init__(self, model: SAM1, mask_threshold: float = 0.0):
        self.model = model
        self.mask_threshold = float(mask_threshold)
        self.reset_image()

    def reset_image(self) -> None:
        self._features = None
        self._orig_hw = None
        self._input_hw = None
        self._is_image_set = False

    # the shared AMG pipeline calls the SAM-2 predictor's method name
    reset_predictor = reset_image

    @torch.no_grad()
    def set_image(self, image, image_format: str = "RGB") -> None:
        """image: [H, W, 3] in 0..255, numpy or torch (uint8 or float)."""
        if image_format not in ("RGB", "BGR"):
            raise ValueError(f"image_format {image_format!r}: expected RGB or BGR")
        if not torch.is_tensor(image):
            image = np.asarray(image)
        if image_format == "BGR":
            image = image.flip(-1) if torch.is_tensor(image) \
                else np.ascontiguousarray(image[..., ::-1])
        self.reset_image()
        self._orig_hw = tuple(image.shape[:2])
        x, self._input_hw = preprocess_image_longest(
            image, self.model.cfg.image_size, model_device(self.model))
        self._features = self.model.forward_image(x[None])
        self._is_image_set = True

    def get_image_embedding(self, channels_first: bool = False):
        """[1, E, E, C] channels-last (the JAX predictor's layout), or
        [1, C, E, E] with channels_first=True (the reference's)."""
        assert self._is_image_set, "call set_image first"
        emb = self._features
        return emb.permute(0, 3, 1, 2) if channels_first else emb

    def _coord_scale(self):
        """Per-axis (sx, sy) from the ROUNDED resized shape: the reference's
        apply_coords scales by (new_w / old_w, new_h / old_h), which differs
        from the longest-side factor by the +0.5 rounding."""
        H, W = self._orig_hw
        nh, nw = self._input_hw
        return nw / W, nh / H

    def _decode(self, embed, coords, labels, boxes, mask_in, multimask: bool):
        """One encoded image, a batch of prompts: (low-res logits f32
        [B, M, 4E, 4E], IoUs f32 [B, M])."""
        m = self.model
        B = (coords.shape[0] if coords is not None else
             boxes.shape[0] if boxes is not None else
             mask_in.shape[0] if mask_in is not None else 1)
        sparse, dense = m.prompt_encoder(
            points=(coords, labels) if coords is not None else None,
            boxes=boxes, masks=mask_in)
        dec = m.mask_decoder(embed.expand(B, *embed.shape[1:]),
                             m.prompt_encoder.get_dense_pe(), sparse, dense,
                             multimask_output=multimask)
        return dec.masks.float(), dec.iou_pred.float()

    def postprocess_masks(self, low_res):
        """[N, h, w] low-res logits -> [N, H, W] at the original size
        (Sam.postprocess_masks: up to the square model resolution, the
        valid region, up to the original size)."""
        size = self.model.cfg.image_size
        nh, nw = self._input_hw
        up = resize_bilinear(low_res[..., None], (size, size))[:, :nh, :nw]
        return resize_bilinear(up, tuple(self._orig_hw))[..., 0]

    @torch.no_grad()
    def predict(self, point_coords: Optional[np.ndarray] = None,
                point_labels: Optional[np.ndarray] = None,
                box: Optional[np.ndarray] = None,
                mask_input: Optional[np.ndarray] = None,
                multimask_output: bool = True,
                return_logits: bool = False):
        """(masks [C, H, W], iou_predictions [C], low_res_logits
        [C, 4E, 4E]), C = 3 with multimask_output, else 1
        (sam1_predictor.py:150-188)."""
        assert self._is_image_set, \
            "an image must be set with set_image(...) before prediction"
        dev = model_device(self.model)
        sc = np.asarray(self._coord_scale(), np.float32)
        coords = labels = boxes = mask_in = None
        if point_coords is not None:
            assert point_labels is not None, \
                "point_labels must be supplied with point_coords"
            coords = torch.from_numpy(np.asarray(point_coords, np.float32) * sc
                                      )[None].to(dev)
            labels = torch.from_numpy(np.asarray(point_labels, np.int32))[None].to(dev)
        if box is not None:
            b = np.asarray(box, np.float32).reshape(1, 2, 2) * sc
            boxes = torch.from_numpy(b.reshape(1, 4)).to(dev)
        if mask_input is not None:
            m = torch.as_tensor(np.asarray(mask_input, np.float32))
            if m.ndim == 3:                                  # [1, h, w]
                m = m[None]
            mask_in = m.permute(0, 2, 3, 1).to(dev)
        low, ious = self._decode(self._features, coords, labels, boxes, mask_in,
                                 bool(multimask_output))
        B, M = low.shape[:2]
        masks = self.postprocess_masks(low.reshape(B * M, *low.shape[2:]))
        masks = masks.reshape(B, M, *self._orig_hw)
        if not return_logits:
            masks = masks > self.mask_threshold
        return (masks[0].cpu().numpy(), ious[0].cpu().numpy(),
                low[0].cpu().numpy())


class SAM1AutomaticMaskGenerator(SAM2AutomaticMaskGenerator):
    """SamAutomaticMaskGenerator over the shared AMG pipeline
    (sam1_predictor.py:199-295): the longest-side coordinate transform,
    one feature level, the longest-side upscale before the resize back to
    the crop, and small-region cleanup inside `_generate_masks`."""

    def __init__(self, model: SAM1, **kw):
        if kw.get("use_m2m", False):
            raise ValueError("SAM-1 has no m2m refinement round")
        super().__init__(model, **kw)

    def _make_predictor(self, model, mask_threshold, min_mask_region_area):
        # SAM-1 cleans small regions after generation, not in the predictor
        return SAM1ImagePredictor(model, mask_threshold=mask_threshold)

    def _model_coords(self, points: np.ndarray, im_size) -> np.ndarray:
        ch, cw = im_size
        nh, nw = preprocess_shape(ch, cw, self.model.cfg.image_size)
        return points * np.array([nw / cw, nh / ch])

    def _decode_fn(self, P: int, multimask: bool, refine: bool):
        assert not refine, "SAM-1 has no m2m refinement round"

        def decode(h0, h1, embed, coords, mask_in):
            labels = torch.ones(P, 1, dtype=torch.int32, device=coords.device)
            low, ious = self.predictor._decode(embed, coords, labels, None, None,
                                               multimask)
            return low.clamp(-32.0, 32.0), ious
        return decode

    def _score_fn(self, N: int, crop_hw: Tuple[int, int]):
        thr = float(self.mask_threshold)
        off = float(self.stability_score_offset)
        size = self.model.cfg.image_size
        nh, nw = preprocess_shape(crop_hw[0], crop_hw[1], size)

        def score(low):
            up = resize_bilinear(low[..., None], (size, size))[:, :nh, :nw]
            return score_masks(resize_bilinear(up, crop_hw)[..., 0], thr, off)
        return score

    def _crop_features(self):
        # one embedding level in the shared pipeline's three-level slot
        return (None, None, self.predictor._features)

    def _generate_masks(self, image):
        data = super()._generate_masks(image)
        if self.min_mask_region_area > 0:
            # SAM-1 runs the cleanup inside generate (sam1_predictor.py:288-295)
            data = self.postprocess_small_regions(
                data, self.min_mask_region_area,
                max(self.box_nms_thresh, self.crop_nms_thresh))
            self._clock("small_regions")
        return data

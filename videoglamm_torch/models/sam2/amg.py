"""SAM-2 automatic mask generator, "segment everything" (PyTorch port of
videoglamm_tpu/models/sam2/amg.py).

- a regular point grid (points_per_side^2, cell-centred in [0,1]^2) is
  decoded in batches of points_per_batch, three masks a point by default;
- candidates are filtered by predicted IoU (> pred_iou_thresh), by
  stability (the IoU of the +offset and -offset binarisations,
  >= stability_score_thresh; 0 on an empty union) and by touching a crop
  edge that is not an image edge (20 px);
- per-crop greedy box NMS (IoU > box_nms_thresh suppresses); with
  crop_n_layers > 0 the whole procedure repeats on overlapping crops and a
  second NMS, scored by 1 / crop area, merges across crops;
- min_mask_region_area > 0 fills holes and removes sprinkles of the low-res
  logits through `ops/connected_components.py`; use_m2m adds one
  refinement round that feeds each candidate's low-res logits back as its
  mask prompt;
- records carry the segmentation (binary mask, uncompressed RLE or COCO
  RLE), area, xywh box, predicted IoU, the prompting point, stability and
  the crop box.

Where the JAX generator copies every candidate's binary mask to the host
before filtering, this one filters on the card (the scores and boxes are
all the filter reads) and brings back only the kept masks' run boundaries:
the records are the same. Decoding, scoring, the mask-to-box reduction
and the run boundaries run on the model's device; NMS and the run lengths
on the host in numpy. The hooks `_make_predictor`, `_model_coords`,
`_decode_fn`, `_score_fn` and `_crop_features` are what a SAM-1 generator
overrides.
"""
from __future__ import annotations

import math
from itertools import product
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...data.rle import rle_decode, rle_encode
from ...ops.connected_components import (connected_components,
                                         postprocess_mask_scores)
from ...ops.resize import resize_bilinear
from ...timing import StageClock
from .image_predictor import SAM2ImagePredictor
from .sam2_base import SAM2Base, model_device


# ---------------------------------------------------------------------------
# grids and crops (amg.py:58-95)
# ---------------------------------------------------------------------------
def build_point_grid(n_per_side: int) -> np.ndarray:
    """Cell-centred n x n grid in [0,1]^2, row-major, (x, y) order."""
    offset = 1 / (2 * n_per_side)
    pts = np.linspace(offset, 1 - offset, n_per_side)
    xs = np.tile(pts[None, :], (n_per_side, 1))
    ys = np.tile(pts[:, None], (1, n_per_side))
    return np.stack([xs, ys], axis=-1).reshape(-1, 2)


def build_all_layer_point_grids(n_per_side: int, n_layers: int,
                                scale_per_layer: int) -> List[np.ndarray]:
    return [build_point_grid(int(n_per_side / (scale_per_layer ** i)))
            for i in range(n_layers + 1)]


def generate_crop_boxes(im_size: Tuple[int, ...], n_layers: int,
                        overlap_ratio: float):
    """Layer i has (2^i)^2 xyxy crops overlapping by a scaled fraction of
    the short side; layer 0 is the full image."""
    im_h, im_w = im_size
    short_side = min(im_h, im_w)
    crop_boxes, layer_idxs = [[0, 0, im_w, im_h]], [0]

    def crop_len(orig_len, n_crops, overlap):
        return int(math.ceil((overlap * (n_crops - 1) + orig_len) / n_crops))

    for i_layer in range(n_layers):
        n_per_side = 2 ** (i_layer + 1)
        overlap = int(overlap_ratio * short_side * (2 / n_per_side))
        crop_w = crop_len(im_w, n_per_side, overlap)
        crop_h = crop_len(im_h, n_per_side, overlap)
        x0s = [int((crop_w - overlap) * i) for i in range(n_per_side)]
        y0s = [int((crop_h - overlap) * i) for i in range(n_per_side)]
        for x0, y0 in product(x0s, y0s):
            crop_boxes.append([x0, y0, min(x0 + crop_w, im_w),
                               min(y0 + crop_h, im_h)])
            layer_idxs.append(i_layer + 1)
    return crop_boxes, layer_idxs


# ---------------------------------------------------------------------------
# host geometry, NMS and RLE helpers (amg.py:98-173)
# ---------------------------------------------------------------------------
def nms_xyxy(boxes: np.ndarray, scores: np.ndarray,
             iou_thresh: float) -> np.ndarray:
    """Greedy box NMS (torchvision semantics: IoU > threshold suppresses;
    descending score, stable on ties)."""
    if len(boxes) == 0:
        return np.zeros((0,), np.int64)
    boxes = boxes.astype(np.float64)
    areas = np.maximum(boxes[:, 2] - boxes[:, 0], 0) * \
        np.maximum(boxes[:, 3] - boxes[:, 1], 0)
    order = np.argsort(-scores, kind="stable")
    keep = []
    while order.size:
        i = order[0]
        keep.append(i)
        rest = order[1:]
        lt = np.maximum(boxes[i, :2], boxes[rest, :2])
        rb = np.minimum(boxes[i, 2:], boxes[rest, 2:])
        wh = np.maximum(rb - lt, 0)
        inter = wh[:, 0] * wh[:, 1]
        iou = inter / np.maximum(areas[i] + areas[rest] - inter, 1e-12)
        order = rest[iou <= iou_thresh]
    return np.asarray(keep, np.int64)


def is_box_near_crop_edge(boxes: np.ndarray, crop_box: List[int],
                          orig_box: List[int],
                          atol: float = 20.0) -> np.ndarray:
    """True for boxes (original-image coordinates) near a crop edge that is
    not also an image edge."""
    crop = np.asarray(crop_box, np.float64)
    orig = np.asarray(orig_box, np.float64)
    b = boxes.astype(np.float64)
    near_crop = np.abs(b - crop[None]) <= atol
    near_img = np.abs(b - orig[None]) <= atol
    return np.any(near_crop & ~near_img, axis=1)


def area_from_rle(rle: Dict[str, Any]) -> int:
    return int(sum(rle["counts"][1::2]))


def _box_xyxy_to_xywh(b) -> List[float]:
    b = [float(v) for v in b]
    return [b[0], b[1], b[2] - b[0], b[3] - b[1]]


def remove_small_regions(mask: np.ndarray, area_thresh: float,
                         mode: str) -> Tuple[np.ndarray, bool]:
    """Fill small holes ("holes") or drop small islands ("islands") of a
    host mask, 8-connected, through `connected_components` on the CPU.
    Returns (mask, changed)."""
    assert mode in ("holes", "islands")
    correct_holes = mode == "holes"
    working = np.asarray(mask, bool) ^ correct_holes
    # rle_decode gives Fortran-ordered masks; the labelling takes C order
    _, areas = connected_components(torch.from_numpy(
        np.ascontiguousarray(working)[None]))
    areas = areas[0].numpy()
    small = (areas > 0) & (areas < area_thresh)
    if not small.any():
        return np.asarray(mask, bool), False
    if correct_holes:
        return np.asarray(mask, bool) | small, True
    kept = working & ~small
    if not kept.any() and working.any():
        # every region below threshold: keep the largest one
        kept = working & (areas == areas.max())
    return kept, True


def rles_from_device_masks(masks, offset: Tuple[int, int],
                           canvas_hw: Tuple[int, int]) -> List[Dict]:
    """Uncompressed COCO RLEs of binary masks [n, h, w] (any device) placed
    at offset (x0, y0) on an all-zero canvas of canvas_hw: equal to
    `rle_encode(canvas, compress=False)` of each. The run boundaries are
    found on the masks' device; only they cross to the host."""
    n, h, w = masks.shape
    if n == 0:
        return []
    H, W = canvas_hw
    x0, y0 = offset
    canvas = torch.zeros(n, W, H, dtype=torch.bool, device=masks.device)
    canvas[:, x0:x0 + w, y0:y0 + h] = masks.transpose(1, 2)   # Fortran order
    flat = canvas.view(n, W * H)
    rows, pos = (flat[:, 1:] != flat[:, :-1]).nonzero(as_tuple=True)
    first = flat[:, 0].cpu().numpy()
    rows, pos = rows.cpu().numpy(), pos.cpu().numpy() + 1
    per_mask = np.split(pos, np.cumsum(np.bincount(rows, minlength=n))[:-1])
    out = []
    for i, changes in enumerate(per_mask):
        counts = np.diff(np.concatenate([[0], changes, [W * H]])).tolist()
        if first[i]:
            counts = [0] + counts
        out.append({"size": [H, W], "counts": counts})
    return out


def score_masks(up, thr: float, off: float):
    """Mask logits at crop resolution [N, Hc, Wc] -> (binary masks, the
    stability score [N]: IoU of the thr + off and thr - off binarisations,
    0 on an empty union, and xyxy boxes [N, 4] int32, [0, 0, 0, 0] for an
    empty mask), on the logits' device."""
    inter = (up > thr + off).sum(dim=(-2, -1))
    union = (up > thr - off).sum(dim=(-2, -1))
    stab = inter / union.clamp_min(1)
    binm = up > thr
    Hc, Wc = up.shape[-2:]
    in_h, in_w = binm.any(dim=-1), binm.any(dim=-2)
    hc = torch.arange(Hc, dtype=torch.int32, device=up.device)
    wc = torch.arange(Wc, dtype=torch.int32, device=up.device)
    bottom = torch.where(in_h, hc, 0).amax(dim=-1)
    top = torch.where(in_h, hc, Hc).amin(dim=-1)
    right = torch.where(in_w, wc, 0).amax(dim=-1)
    left = torch.where(in_w, wc, Wc).amin(dim=-1)
    empty = (right < left) | (bottom < top)
    boxes = torch.stack([left, top, right, bottom], dim=-1)
    return binm, stab, torch.where(empty[:, None], 0, boxes)


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------
class SAM2AutomaticMaskGenerator:
    """Grid-prompted everything-mode segmentation over a built SAM2Base."""

    def __init__(self, model: SAM2Base,
                 points_per_side: Optional[int] = 32,
                 points_per_batch: int = 64,
                 pred_iou_thresh: float = 0.8,
                 stability_score_thresh: float = 0.95,
                 stability_score_offset: float = 1.0,
                 mask_threshold: float = 0.0,
                 box_nms_thresh: float = 0.7,
                 crop_n_layers: int = 0,
                 crop_nms_thresh: float = 0.7,
                 crop_overlap_ratio: float = 512 / 1500,
                 crop_n_points_downscale_factor: int = 1,
                 point_grids: Optional[List[np.ndarray]] = None,
                 min_mask_region_area: int = 0,
                 output_mode: str = "binary_mask",
                 use_m2m: bool = False,
                 multimask_output: bool = True):
        assert (points_per_side is None) != (point_grids is None), \
            "exactly one of points_per_side or point_grids must be provided"
        self.point_grids = (point_grids if point_grids is not None else
                            build_all_layer_point_grids(
                                points_per_side, crop_n_layers,
                                crop_n_points_downscale_factor))
        assert output_mode in ("binary_mask", "uncompressed_rle", "coco_rle")
        self.predictor = self._make_predictor(model, mask_threshold,
                                              min_mask_region_area)
        self.model = model
        self.points_per_batch = points_per_batch
        self.pred_iou_thresh = pred_iou_thresh
        self.stability_score_thresh = stability_score_thresh
        self.stability_score_offset = stability_score_offset
        self.mask_threshold = mask_threshold
        self.box_nms_thresh = box_nms_thresh
        self.crop_n_layers = crop_n_layers
        self.crop_nms_thresh = crop_nms_thresh
        self.crop_overlap_ratio = crop_overlap_ratio
        self.crop_n_points_downscale_factor = crop_n_points_downscale_factor
        self.min_mask_region_area = min_mask_region_area
        self.output_mode = output_mode
        self.use_m2m = use_m2m
        self.multimask_output = multimask_output
        self._clock = StageClock(None, model_device(model))

    # -- hooks (a SAM-1 generator overrides these) -------------------------
    def _make_predictor(self, model, mask_threshold, min_mask_region_area):
        return SAM2ImagePredictor(
            model, mask_threshold=mask_threshold,
            max_hole_area=min_mask_region_area,
            max_sprinkle_area=min_mask_region_area)

    def _model_coords(self, points: np.ndarray, im_size) -> np.ndarray:
        """Pixel coordinates in the (cropped) image -> model space: divided
        by the image size, times the square model resolution."""
        ch, cw = im_size
        return (points / np.array([cw, ch])) * self.model.cfg.image_size

    def _decode_fn(self, P: int, multimask: bool, refine: bool):
        """-> decode(h0, h1, embed, coords [P, 1, 2], mask_in) ->
        (low-res logits clamped to +-32 [P, M, h, w], IoUs [P, M]);
        refine: a low-res mask prompt [P, h, w] comes with each point (the
        m2m round, one mask)."""
        def decode(h0, h1, embed, coords, mask_in):
            labels = torch.ones(P, 1, dtype=torch.int32, device=coords.device)
            low, ious = self.predictor._decode(
                h0, h1, embed, coords, labels,
                None if mask_in is None else mask_in[..., None],
                multimask and not refine)
            return low.clamp(-32.0, 32.0), ious
        return decode

    def _score_fn(self, N: int, crop_hw: Tuple[int, int]):
        """-> score(low [N, h, w]) -> (binary masks at crop resolution
        [N, Hc, Wc], stability [N], xyxy boxes [N, 4] int32, [0, 0, 0, 0]
        for an empty mask): the optional hole / sprinkle fill, the bilinear
        upscale, the two-threshold stability and the mask-to-box
        reduction, on the logits' device."""
        thr = float(self.mask_threshold)
        off = float(self.stability_score_offset)
        hole = float(self.min_mask_region_area)

        def score(low):
            filled = low
            if hole > 0:
                filled = postprocess_mask_scores(
                    low, max_hole_area=hole, max_sprinkle_area=hole,
                    mask_threshold=thr)
                self._clock("connected_components")
            up = resize_bilinear(filled[..., None], crop_hw)[..., 0]
            return score_masks(up, thr, off)
        return score

    def _crop_features(self):
        """The three feature levels `_decode_fn`'s decode takes."""
        return self.predictor._features

    # -- the pipeline ----------------------------------------------------------
    @torch.no_grad()
    def generate(self, image, timings: Optional[dict] = None
                 ) -> List[Dict[str, Any]]:
        """image: [H, W, 3] RGB uint8 (numpy, or a torch tensor on any
        device). One record per kept mask. With a `timings` dict, the
        seconds of each stage are added to it: encode, decode (with the m2m
        round), score, connected_components (inside scoring, when
        min_mask_region_area > 0), filter, rle (run boundaries on the
        device, run lengths on the host), nms, records."""
        if not torch.is_tensor(image):
            image = np.asarray(image)
        self._clock = StageClock(timings, model_device(self.model))
        data = self._generate_masks(image)
        if self.output_mode == "coco_rle":
            segs = [dict(rle, counts=rle_encode(rle_decode(rle))["counts"])
                    for rle in data["rles"]]
        elif self.output_mode == "binary_mask":
            segs = [rle_decode(rle) for rle in data["rles"]]
        else:
            segs = data["rles"]
        records = [{
            "segmentation": segs[i],
            "area": area_from_rle(data["rles"][i]),
            "bbox": _box_xyxy_to_xywh(data["boxes"][i]),
            "predicted_iou": float(data["iou_preds"][i]),
            "point_coords": [data["points"][i].tolist()],
            "stability_score": float(data["stability_score"][i]),
            "crop_box": _box_xyxy_to_xywh(data["crop_boxes"][i]),
        } for i in range(len(segs))]
        self._clock("records")
        self._clock = StageClock(None, model_device(self.model))
        return records

    def _generate_masks(self, image) -> Dict[str, Any]:
        orig_size = tuple(image.shape[:2])
        crop_boxes, layer_idxs = generate_crop_boxes(
            orig_size, self.crop_n_layers, self.crop_overlap_ratio)
        data = _cat_all([self._process_crop(image, cb, li, orig_size)
                         for cb, li in zip(crop_boxes, layer_idxs)])
        if len(crop_boxes) > 1:
            # dedup across crops, preferring masks from smaller crops
            cb = data["crop_boxes"].astype(np.float64)
            scores = 1.0 / np.maximum(
                (cb[:, 2] - cb[:, 0]) * (cb[:, 3] - cb[:, 1]), 1e-12)
            keep = nms_xyxy(data["boxes"].astype(np.float64), scores,
                            self.crop_nms_thresh)
            data = _filter(data, keep)
            self._clock("nms")
        return data

    def _process_crop(self, image, crop_box, layer_idx, orig_size):
        x0, y0, x1, y1 = crop_box
        crop = image[y0:y1, x0:x1, :]
        ch, cw = crop.shape[:2]
        self.predictor.set_image(crop)
        feats = self._crop_features()
        self._clock("encode")

        pts = self.point_grids[layer_idx] * np.array([cw, ch])[None]
        P = self.points_per_batch
        batches = []
        for s in range(0, len(pts), P):
            chunk = pts[s:s + P]
            n_real = len(chunk)
            if n_real < P:  # pad to the batch shape with the last point
                chunk = np.concatenate(
                    [chunk, np.tile(chunk[-1:], (P - n_real, 1))])
            batches.append(self._process_batch(
                chunk, n_real, (ch, cw), crop_box, orig_size, feats))
        self.predictor.reset_predictor()
        data = _cat_all(batches)

        keep = nms_xyxy(data["boxes"].astype(np.float64),
                        data["iou_preds"].astype(np.float64),
                        self.box_nms_thresh)
        data = _filter(data, keep)
        data["boxes"] = data["boxes"] + np.array([x0, y0, x0, y0])
        data["points"] = data["points"] + np.array([x0, y0])
        data["crop_boxes"] = np.tile(np.asarray(crop_box, np.float64)[None],
                                     (len(data["rles"]), 1))
        self._clock("nms")
        return data

    def _process_batch(self, points, n_real, im_size, crop_box, orig_size,
                       feats):
        ch, cw = im_size
        orig_h, orig_w = orig_size
        P = len(points)
        dev = model_device(self.model)

        def to_model(pts):
            c = self._model_coords(pts, im_size).astype(np.float32)
            return torch.from_numpy(c).to(dev)[:, None, :]

        h0, h1, embed = feats
        low, ious = self._decode_fn(P, self.multimask_output, False)(
            h0, h1, embed, to_model(points), None)
        M = low.shape[1]
        N = P * M
        low = low.reshape(N, *low.shape[2:])
        ious = ious.reshape(N)
        pts_rep = np.repeat(points, M, axis=0)
        if self.use_m2m:
            # one refinement round: each candidate's clamped low-res logits
            # are the mask prompt of its own point, one mask out (N is a
            # multiple of P, so every chunk is whole)
            r_coords = to_model(pts_rep)
            refine = self._decode_fn(P, False, True)
            outs = [refine(h0, h1, embed, r_coords[s:s + P], low[s:s + P])
                    for s in range(0, N, P)]
            low = torch.cat([lo[:, 0] for lo, _ in outs])
            ious = torch.cat([io[:, 0] for _, io in outs])
        self._clock("decode")

        binm, stab, boxes = self._score_fn(N, (ch, cw))(low)
        self._clock("score")
        # padded grid points out, then the filters, on the scores alone
        n = n_real * M
        data = dict(iou_preds=ious[:n].cpu().numpy(), points=pts_rep[:n],
                    stability_score=stab[:n].cpu().numpy(),
                    boxes=boxes[:n].cpu().numpy().astype(np.float64))
        keep = np.ones(n, bool)
        if self.pred_iou_thresh > 0.0:
            keep &= data["iou_preds"] > self.pred_iou_thresh
        if self.stability_score_thresh > 0.0:
            keep &= data["stability_score"] >= self.stability_score_thresh
        x0, y0, _, _ = crop_box
        keep &= ~is_box_near_crop_edge(
            data["boxes"] + np.array([x0, y0, x0, y0]), crop_box,
            [0, 0, orig_w, orig_h])
        idx = np.flatnonzero(keep)
        data = _filter(data, idx)
        kept = binm[torch.from_numpy(idx).to(dev)]
        self._clock("filter")
        # uncropped into the full canvas (pycocotools layout)
        data["rles"] = rles_from_device_masks(kept, (x0, y0), (orig_h, orig_w))
        self._clock("rle")
        return data

    @staticmethod
    def postprocess_small_regions(data: Dict[str, Any], min_area: int,
                                  nms_thresh: float) -> Dict[str, Any]:
        """Remove small disconnected regions and holes from every mask,
        then re-run box NMS preferring unchanged masks (amg.py:455-493)."""
        if len(data["rles"]) == 0:
            return data
        new_masks, scores = [], []
        for rle in data["rles"]:
            mask = rle_decode(rle)
            mask, ch1 = remove_small_regions(mask, min_area, "holes")
            mask, ch2 = remove_small_regions(mask, min_area, "islands")
            new_masks.append(mask)
            scores.append(float(not (ch1 or ch2)))
        masks = np.stack(new_masks)
        ys = masks.any(axis=2)
        xs = masks.any(axis=1)
        H, W = masks.shape[1:]
        hidx, widx = np.arange(H), np.arange(W)
        bottom = np.where(ys, hidx[None], 0).max(1)
        top = np.where(ys, hidx[None], H).min(1)
        right = np.where(xs, widx[None], 0).max(1)
        left = np.where(xs, widx[None], W).min(1)
        empty = (right < left) | (bottom < top)
        boxes = np.stack([left, top, right, bottom], axis=-1)
        boxes = np.where(empty[:, None], 0, boxes).astype(np.float64)
        keep = nms_xyxy(boxes, np.asarray(scores), nms_thresh)
        for i in keep:
            if scores[i] == 0.0:  # changed: refresh RLE and box
                data["rles"][i] = rle_encode(masks[i], compress=False)
                data["boxes"][i] = boxes[i]
        return _filter(data, keep)


def _filter(data: Dict[str, Any], keep: np.ndarray) -> Dict[str, Any]:
    return {k: [v[i] for i in keep] if isinstance(v, list) else v[keep]
            for k, v in data.items()}


def _cat_all(parts: List[Dict[str, Any]]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for p in parts:
        for k, v in p.items():
            if k not in out:
                out[k] = list(v) if isinstance(v, list) else v
            elif isinstance(v, list):
                out[k] = out[k] + v
            else:
                out[k] = np.concatenate([out[k], v], axis=0)
    return out

"""Evaluation metrics, host-side numpy and scipy (the port's copy of
videoglamm_tpu/evals/metrics.py; no function differs).

Behavioral contracts:
- GCG mask mIoU with greedy one-to-one matching + grounded recall with dual
  IoU/text-similarity thresholds (reference eval_gcg_metrics.py:23-177);
- official DAVIS J (region Jaccard, eval_referdavis_metrics.py:147-178) and
  F (boundary F-measure via dilated boundary matching, :181-260) +
  mean/recall/decay statistics (:322-346);
- ReasonSeg gIoU/cIoU accumulators (utils/utils.py intersectionAndUnionGPU,
  trainer.py:301-373);
- spatio-temporal grounding tIoU/vIoU (eval_grounding.py:20-72) and
  masks_to_boxes / box IoU (utils/grounding_utils/box_ops.py:46-142).

cv2/skimage are not dependencies: dilation uses scipy.ndimage with a disk
structuring element; everything else is plain numpy.
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Sequence, Tuple

import numpy as np
from scipy import ndimage


# ---------------------------------------------------------------------------
# basic IoU
# ---------------------------------------------------------------------------
def compute_iou(mask1: np.ndarray, mask2: np.ndarray) -> float:
    """IoU over the full (possibly temporal) tube."""
    inter = np.logical_and(mask1, mask2).sum()
    union = np.logical_or(mask1, mask2).sum()
    return float(inter / union) if union > 0 else 0.0


def compute_miou(pred_masks: Sequence[np.ndarray],
                 gt_masks: Sequence[np.ndarray]) -> float:
    """Greedy one-to-one matched mean IoU (reference
    eval_gcg_metrics.py:38-57)."""
    pred_masks = list(pred_masks)
    gt_masks = list(gt_masks)
    iou = np.zeros((len(pred_masks), len(gt_masks)))
    for i, p in enumerate(pred_masks):
        for j, g in enumerate(gt_masks):
            iou[i, j] = compute_iou(p, g)
    paired = []
    while iou.size > 0 and np.max(iou) > 0:
        idx = np.unravel_index(np.argmax(iou), iou.shape)
        paired.append(iou[idx])
        iou = np.delete(iou, idx[0], axis=0)
        iou = np.delete(iou, idx[1], axis=1)
    return float(np.mean(paired)) if paired else 0.0


def find_best_matches(gt_masks, gt_labels, pred_masks, pred_labels,
                      text_sim_fn, iou_threshold=0.5,
                      text_sim_threshold=0.5) -> List[Tuple[int, int]]:
    """Greedy matching requiring IoU >= thr AND text-sim >= thr (reference
    eval_gcg_metrics.py:115-155). `text_sim_fn(a, b) -> float` is pluggable
    (the reference uses BERT mean-pooled cosine)."""
    gt_masks, pred_masks = list(gt_masks), list(pred_masks)
    ious = np.zeros((len(gt_masks), len(pred_masks)))
    for i, g in enumerate(gt_masks):
        for j, p in enumerate(pred_masks):
            ious[i, j] = compute_iou(g, p)
    sims = np.zeros_like(ious)
    for i, gl in enumerate(gt_labels):
        for j, pl in enumerate(pred_labels):
            sims[i, j] = text_sim_fn(gl, pl)
    matches = []
    while ious.size > 0:
        idx = np.unravel_index(np.argmax(ious), ious.shape)
        if ious[idx] < iou_threshold or sims[idx] < text_sim_threshold:
            break
        matches.append(idx)
        ious[idx[0], :] = 0
        ious[:, idx[1]] = 0
        sims[idx[0], :] = 0
        sims[:, idx[1]] = 0
    return matches


# ---------------------------------------------------------------------------
# DAVIS J & F
# ---------------------------------------------------------------------------
def davis_j(annotation: np.ndarray, segmentation: np.ndarray,
            void_pixels=None) -> np.ndarray:
    """Per-frame region Jaccard; union==0 counts as 1 (reference
    db_eval_iou, eval_referdavis_metrics.py:147-178)."""
    a = annotation.astype(bool)
    s = segmentation.astype(bool)
    void = np.zeros_like(s) if void_pixels is None else void_pixels.astype(bool)
    inter = np.sum((s & a) & ~void, axis=(-2, -1))
    union = np.sum((s | a) & ~void, axis=(-2, -1))
    with np.errstate(invalid="ignore", divide="ignore"):
        j = inter / union
    j = np.where(np.isclose(union, 0), 1.0, j)
    return j


def _disk(radius: int) -> np.ndarray:
    L = np.arange(-radius, radius + 1)
    X, Y = np.meshgrid(L, L)
    return (X ** 2 + Y ** 2) <= radius ** 2


def boundary_f_measure(foreground_mask: np.ndarray, gt_mask: np.ndarray,
                       bound_th: float = 0.008) -> float:
    """Boundary F (reference f_measure, eval_referdavis_metrics.py:199-260)."""
    from .postprocess import seg2bmap

    bound_pix = bound_th if bound_th >= 1 else \
        int(np.ceil(bound_th * np.linalg.norm(foreground_mask.shape)))

    fg_boundary = seg2bmap(foreground_mask)
    gt_boundary = seg2bmap(gt_mask)

    selem = _disk(int(bound_pix))
    fg_dil = ndimage.binary_dilation(fg_boundary, selem)
    gt_dil = ndimage.binary_dilation(gt_boundary, selem)

    gt_match = gt_boundary & fg_dil
    fg_match = fg_boundary & gt_dil
    n_fg = fg_boundary.sum()
    n_gt = gt_boundary.sum()

    if n_fg == 0 and n_gt > 0:
        precision, recall = 1.0, 0.0
    elif n_fg > 0 and n_gt == 0:
        precision, recall = 0.0, 1.0
    elif n_fg == 0 and n_gt == 0:
        precision, recall = 1.0, 1.0
    else:
        precision = fg_match.sum() / float(n_fg)
        recall = gt_match.sum() / float(n_gt)
    if precision + recall == 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


def db_statistics(per_frame_values: np.ndarray) -> Tuple[float, float, float]:
    """(mean, recall@0.5, decay) over per-frame values (reference
    eval_referdavis_metrics.py:322-346)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", category=RuntimeWarning)
        M = np.nanmean(per_frame_values)
        O = np.nanmean(per_frame_values > 0.5)
    n_bins = 4
    ids = np.round(np.linspace(1, len(per_frame_values), n_bins + 1)
                   + 1e-10) - 1
    ids = ids.astype(int)
    D_bins = [per_frame_values[ids[i]:ids[i + 1] + 1] for i in range(n_bins)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", category=RuntimeWarning)
        D = np.nanmean(D_bins[0]) - np.nanmean(D_bins[3])
    return float(M), float(O), float(D)


# ---------------------------------------------------------------------------
# ReasonSeg gIoU / cIoU
# ---------------------------------------------------------------------------
def intersection_and_union(pred: np.ndarray, target: np.ndarray, K: int = 2,
                           ignore_index: int = 255):
    """Per-class (intersection, union, target-area) histograms (reference
    utils/utils.py intersectionAndUnionGPU semantics on host)."""
    pred = pred.reshape(-1).copy()
    target = target.reshape(-1)
    pred[target == ignore_index] = ignore_index
    inter = pred[pred == target]
    area_inter = np.histogram(inter, bins=K, range=(0, K - 1))[0]
    area_pred = np.histogram(pred, bins=K, range=(0, K - 1))[0]
    area_target = np.histogram(target, bins=K, range=(0, K - 1))[0]
    return area_inter, area_pred + area_target - area_inter, area_target


class AverageMeter:
    """Running mean accumulator (reference utils/utils.py:14-60)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0.0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += np.asarray(val) * n
        self.count += n

    @property
    def avg(self):
        return self.sum / max(self.count, 1e-8)


# ---------------------------------------------------------------------------
# spatio-temporal grounding
# ---------------------------------------------------------------------------
def masks_to_boxes(masks: np.ndarray) -> np.ndarray:
    """[N, H, W] binary -> [N, 4] xyxy (reference box_ops.py:118-142)."""
    if masks.size == 0:
        return np.zeros((0, 4), np.float32)
    h, w = masks.shape[-2:]
    y, x = np.meshgrid(np.arange(h, dtype=np.float32),
                       np.arange(w, dtype=np.float32), indexing="ij")
    m = masks.astype(bool)
    x_mask = masks * x[None]
    x_max = x_mask.reshape(len(masks), -1).max(-1)
    x_min = np.where(m, x[None], 1e8).reshape(len(masks), -1).min(-1)
    y_mask = masks * y[None]
    y_max = y_mask.reshape(len(masks), -1).max(-1)
    y_min = np.where(m, y[None], 1e8).reshape(len(masks), -1).min(-1)
    return np.stack([x_min, y_min, x_max, y_max], 1).astype(np.float32)


def np_box_iou(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """Pairwise xyxy IoU (reference box_ops.py:46)."""
    area1 = (boxes1[:, 2] - boxes1[:, 0]) * (boxes1[:, 3] - boxes1[:, 1])
    area2 = (boxes2[:, 2] - boxes2[:, 0]) * (boxes2[:, 3] - boxes2[:, 1])
    lt = np.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = np.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[:, None] + area2[None, :] - inter
    with np.errstate(invalid="ignore", divide="ignore"):
        iou = np.where(union > 0, inter / union, 0.0)
    return iou


def temporal_iou(gt_sted, pred_sted, frame_ids):
    """(tIoU, union frames, intersection frames) (reference
    eval_grounding.py:55-72)."""
    max_start = max(gt_sted[0], pred_sted[0])
    min_end = min(gt_sted[1], pred_sted[1])
    min_start = min(gt_sted[0], pred_sted[0])
    max_end = max(gt_sted[1], pred_sted[1])
    if min_end <= max_start:
        tiou = 0.0
    else:
        inter = min_end - max_start
        union = (gt_sted[1] - gt_sted[0]) + (pred_sted[1] - pred_sted[0]) \
            - inter
        tiou = inter / union
    union_predgt = [f for f in frame_ids if min_start <= f < max_end]
    inter_predgt = set(f for f in frame_ids if max_start <= f < min_end)
    return tiou, union_predgt, inter_predgt


def video_iou(pred_boxes: Dict[int, np.ndarray],
              gt_boxes: Dict[int, np.ndarray],
              union_frames: Sequence[int],
              inter_frames) -> float:
    """vIoU = sum of per-frame box IoUs over intersection frames divided by
    |union| (reference eval_grounding.py usage)."""
    if not union_frames:
        return 0.0
    v = 0.0
    for f in inter_frames:
        if f in pred_boxes and f in gt_boxes:
            v += float(np_box_iou(np.asarray(pred_boxes[f])[None],
                                  np.asarray(gt_boxes[f])[None])[0, 0])
    return v / len(union_frames)

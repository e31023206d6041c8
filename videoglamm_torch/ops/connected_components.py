"""Connected components (8-connectivity) and the mask cleanups built on
them (PyTorch port of videoglamm_tpu/ops/connected_components.py).

The algorithm is the JAX package's, step for step, so that labels and
areas are equal to its own: min-label propagation over the 3x3
neighbourhood, then two pointer jumps (label -> label of the pixel it
names) a sweep, until a sweep changes nothing. The JAX loop is a
`lax.while_loop`; here each sweep's convergence test is one host
synchronisation. No Pallas kernel stands behind the JAX function, so the
sweeps are plain tensor operations on either device.

Consumers: hole filling and sprinkle removal on low-res mask logits
(`postprocess_mask_scores`, the SAM-2 transforms' postprocessing), the
automatic mask generator's small-region cleanup, and small-blob removal.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_BIG = 2 ** 30


def connected_components(mask):
    """mask [B, H, W] bool -> (labels, areas), both int32 [B, H, W]:
    1-based component ids on the foreground (the smallest flat index of the
    component, plus one), 0 on the background; the component's size on
    each foreground pixel, 0 on the background."""
    mask = mask.bool()
    B, H, W = mask.shape
    HW = H * W
    init = torch.arange(HW, dtype=torch.int32, device=mask.device).view(1, H, W)
    lab = torch.where(mask, init, _BIG)
    while True:
        p = F.pad(lab, (1, 1, 1, 1), value=_BIG)
        m = lab
        for dy in range(3):
            for dx in range(3):
                m = torch.minimum(m, p[:, dy:dy + H, dx:dx + W])
        flat = torch.where(mask, m, _BIG).view(B, HW)
        for _ in range(2):      # pointer jumping
            jumped = torch.gather(flat, 1, flat.clamp(0, HW - 1).long())
            flat = torch.where(flat < _BIG, jumped, _BIG)
        new = flat.view(B, H, W)
        changed = bool((new != lab).any())
        lab = new
        if not changed:
            break

    root = lab.view(B, HW).clamp(0, HW - 1).long()
    areas_by_root = torch.zeros(B, HW, dtype=torch.int32, device=mask.device)
    areas_by_root.scatter_add_(1, root, mask.view(B, HW).int())
    areas = torch.where(mask, torch.gather(areas_by_root, 1, root).view(B, H, W), 0)
    labels = torch.where(mask, lab + 1, 0)
    return labels.int(), areas.int()


def postprocess_mask_scores(masks, max_hole_area: float = 0.0,
                            max_sprinkle_area: float = 0.0,
                            mask_threshold: float = 0.0):
    """masks [B, H, W] logits -> f32 logits with background components of
    area <= max_hole_area set to threshold + 10 (holes filled) and then
    foreground components of area <= max_sprinkle_area set to threshold - 10
    (sprinkles removed), as SAM2Transforms.postprocess_masks does."""
    out = masks.float()
    if max_hole_area > 0:
        _, areas = connected_components(out <= mask_threshold)
        out = torch.where((areas > 0) & (areas <= max_hole_area),
                          mask_threshold + 10.0, out)
    if max_sprinkle_area > 0:
        _, areas = connected_components(out > mask_threshold)
        out = torch.where((areas > 0) & (areas <= max_sprinkle_area),
                          mask_threshold - 10.0, out)
    return out


def remove_small_objects_device(mask, min_size: int):
    """mask [B, H, W] bool -> the mask without its components smaller
    than min_size pixels."""
    if min_size <= 0:
        return mask
    _, areas = connected_components(mask)
    return mask.bool() & (areas >= min_size)

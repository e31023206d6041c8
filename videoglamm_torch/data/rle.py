"""COCO RLE mask codec in numpy (the port's own copy of
videoglamm_tpu/data/rle.py, which the port does not import).

pycocotools semantics: Fortran-order run lengths starting with the count of
zeros, and the LEB128-like signed-delta string compression of `encode` /
`decode` for {"size", "counts": str|bytes} objects. Uncompressed
{"counts": [ints]} is accepted too.
"""
from __future__ import annotations

from typing import Dict, List, Union

import numpy as np


def _decode_compressed_counts(s: Union[str, bytes]) -> List[int]:
    if isinstance(s, str):
        s = s.encode("ascii")
    counts: List[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def _encode_compressed_counts(counts: List[int]) -> str:
    out = bytearray()
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(c + 48)
    return out.decode("ascii")


def rle_decode(rle: Dict) -> np.ndarray:
    """{"size": [h, w], "counts": ...} -> bool [h, w] mask."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = _decode_compressed_counts(counts)
    flat = np.zeros(h * w, dtype=bool)
    pos = 0
    val = False
    for c in counts:
        if val:
            flat[pos:pos + c] = True
        pos += c
        val = not val
    return flat.reshape((w, h)).T  # Fortran order


def rle_encode(mask: np.ndarray, compress: bool = True) -> Dict:
    """bool [h, w] mask -> COCO RLE object."""
    h, w = mask.shape
    flat = np.asarray(mask, bool).T.reshape(-1)  # Fortran order
    # run lengths, starting with zeros-count
    changes = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    bounds = np.concatenate([[0], changes, [flat.size]])
    counts = np.diff(bounds).tolist()
    if flat.size and flat[0]:
        counts = [0] + counts
    if not flat.size:
        counts = [0]
    return {"size": [h, w],
            "counts": _encode_compressed_counts(counts) if compress
            else counts}

"""Video frame loading (the port's counterpart of
videoglamm_tpu/data/video_reader.py): video files through the native FFmpeg
library `native/frameloader.cpp` bound with ctypes; frame directories
(DAVIS / MeViS / YTVOS-style image folders) through PIL, a second input
format.

The library is built at first use from the source where it lies in the
checkout, into the git-ignored `build/native/` beside the port's CUDA
libraries, under a name that carries a digest of the source and the
command, so a stale build is never loaded. If it cannot be built, opening a
video raises: nothing falls back to another decoder.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SRC_PATH = _ROOT / "native" / "frameloader.cpp"
BUILD_DIR = _ROOT / "build" / "native"
LIBS = ("-lavformat", "-lavcodec", "-lavutil", "-lswscale")

_lib = None
_lock = threading.Lock()


def _build_native() -> Path:
    """Compile the frame loader into BUILD_DIR (if not already there) and
    return the library's path; raises with g++'s report when it fails."""
    flags = ["-O2", "-shared", "-fPIC"]
    digest = hashlib.sha256(SRC_PATH.read_bytes()
                            + " ".join(flags + list(LIBS)).encode()
                            ).hexdigest()[:16]
    so = BUILD_DIR / f"libvglframes-{digest}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *flags, str(SRC_PATH), "-o", str(tmp), *LIBS],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building the native frame loader from {SRC_PATH} "
                           f"failed:\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def get_native_lib():
    """Load (building if needed) the native frame loader; raises when it
    cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_build_native()))
        lib.vgl_open.restype = ctypes.c_void_p
        lib.vgl_open.argtypes = [ctypes.c_char_p]
        lib.vgl_close.argtypes = [ctypes.c_void_p]
        lib.vgl_num_frames.restype = ctypes.c_long
        lib.vgl_num_frames.argtypes = [ctypes.c_void_p]
        lib.vgl_fps.restype = ctypes.c_double
        lib.vgl_fps.argtypes = [ctypes.c_void_p]
        lib.vgl_width.restype = ctypes.c_int
        lib.vgl_width.argtypes = [ctypes.c_void_p]
        lib.vgl_height.restype = ctypes.c_int
        lib.vgl_height.argtypes = [ctypes.c_void_p]
        lib.vgl_read_frames.restype = ctypes.c_int
        lib.vgl_read_frames.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_long), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int]
        lib.vgl_write_test_video.restype = ctypes.c_int
        lib.vgl_write_test_video.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        _lib = lib
        return lib


class VideoReader:
    """decord.VideoReader-like access over the native loader."""

    def __init__(self, path: str):
        self._h = None
        self._lib = get_native_lib()
        self._h = self._lib.vgl_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open video: {path}")

    def __len__(self) -> int:
        return int(self._lib.vgl_num_frames(self._h))

    @property
    def fps(self) -> float:
        return float(self._lib.vgl_fps(self._h))

    @property
    def size(self):
        return (self._lib.vgl_width(self._h), self._lib.vgl_height(self._h))

    def get_batch(self, indices: Sequence[int],
                  out_size: Optional[tuple] = None) -> np.ndarray:
        """Decode frames at ascending `indices` -> [n, H, W, 3] uint8 RGB."""
        idx = np.asarray(sorted(indices), np.int64)
        w, h = out_size or self.size
        out = np.empty((len(idx), h, w, 3), np.uint8)
        n = self._lib.vgl_read_frames(
            self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            len(idx), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            w, h)
        if n != len(idx):
            raise IOError(f"decoded {n}/{len(idx)} frames")
        return out

    def close(self):
        if self._h:
            self._lib.vgl_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def write_test_video(path: str, w: int = 64, h: int = 48, n_frames: int = 25,
                     fps: int = 5):
    """A synthetic clip through the native writer: frame f has the base
    colour ((23f+40), (47f+80), (71f+120)) mod 256 and a white square."""
    rc = get_native_lib().vgl_write_test_video(path.encode(), w, h, n_frames,
                                               fps)
    if rc != 0:
        raise IOError(f"test video write failed: {rc}")


IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def load_frame_dir(path: str, indices: Optional[Sequence[int]] = None
                   ) -> List[np.ndarray]:
    """Frame-directory loader (DAVIS / MeViS / YTVOS layout): sorted image
    files -> list of RGB uint8 arrays."""
    from PIL import Image
    files = sorted(f for f in os.listdir(path)
                   if f.lower().endswith(IMG_EXTS))
    if indices is not None:
        files = [files[i] for i in indices]
    return [np.asarray(Image.open(os.path.join(path, f)).convert("RGB"))
            for f in files]


def load_video_frames(path: str, num_frames: int, fps_sample: float = 1.0,
                      max_frames: int = 64) -> List[np.ndarray]:
    """Sample at about `fps_sample` frames a second, at most `max_frames`
    decoded frames, then linspace-subsample to `num_frames`. Takes a video
    file (native decoder) or a frame directory."""
    from .preprocess import sample_frame_indices

    if os.path.isdir(path):
        frames = load_frame_dir(path)
        total = len(frames)
        idx = sample_frame_indices(total, num_frames)
        return [frames[i] for i in idx]

    vr = VideoReader(path)
    total = len(vr)
    fps = vr.fps or 25.0
    stride = max(int(round(fps / fps_sample)), 1)
    decode_idx = list(range(0, total, stride))[:max_frames]
    if not decode_idx:
        decode_idx = [0]
    frames = vr.get_batch(decode_idx)
    vr.close()
    sub = sample_frame_indices(len(frames), num_frames)
    return [frames[i] for i in sub]

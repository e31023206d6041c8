"""The port's on-device preprocessing against the JAX package on the CPU:
raw uint8 frames -> the InternVideo2, CLIP and SAM streams.

Random uint8 clips from a numpy seed, non-square in both orientations, go
through `videoglamm_tpu.ops.preprocess` and its port. Both apply the same
f32 resize matrices (the port keeps its own copy of the numpy builders) as
two products per stream, so they differ only in summation order: 1e-5
absolute on normalised outputs of magnitude O(1).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoglamm_tpu.ops import preprocess as jpre
from videoglamm_tpu.ops import resize as jresize
from videoglamm_torch.config import VideoGLaMMConfig
from videoglamm_torch.inference.pipeline import prepare_vision_inputs
from videoglamm_torch.ops import preprocess as tpre
from videoglamm_torch.ops import resize as tresize
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-5
CLIPS = {"portrait": (2, 53, 37), "landscape": (2, 37, 53),
         "davis_like": (1, 48, 85)}
SIZES = dict(iv_size=28, clip_size=56, sam_size=128)


def _clip(name):
    T, H, W = CLIPS[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    return rng.randint(0, 256, size=(T, H, W, 3)).astype(np.uint8)


@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
@pytest.mark.parametrize("sizes", [(480, 224), (37, 56), (85, 128), (53, 53)])
def test_resize_matrices_equal_the_jax_builders(mode, sizes):
    """The copied numpy builders give the JAX package's matrices exactly."""
    a, b = sizes
    np.testing.assert_array_equal(tresize.pil_resize_matrix(a, b, mode),
                                  jresize.pil_resize_matrix(a, b, mode))
    np.testing.assert_array_equal(tresize._linear_matrix(a, b),
                                  jresize._linear_matrix(a, b))


@pytest.mark.parametrize("name", list(CLIPS))
def test_preprocess_streams_match_jax(name):
    raw = _clip(name)
    ref = jpre.preprocess_streams(jnp.asarray(raw), **SIZES)
    got = tpre.preprocess_streams(torch.from_numpy(raw), **SIZES)
    for stream, g, r, size in zip(("iv", "clip", "sam"), got, ref,
                                  SIZES.values()):
        assert g.shape == (raw.shape[0], size, size, 3) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TOL, rtol=0,
                                   err_msg=f"{name} {stream}")


@pytest.mark.parametrize("name", list(CLIPS))
def test_flagship_sizes_match_jax(name):
    """The default sizes (224 / 336 / 1024) on the same small clips."""
    raw = _clip(name)[:1]
    ref = jpre.preprocess_streams(jnp.asarray(raw))
    got = tpre.preprocess_streams(torch.from_numpy(raw))
    for g, r, size in zip(got, ref, (224, 336, 1024)):
        assert g.shape == (1, size, size, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TOL, rtol=0)


def test_prepare_vision_inputs_batches_and_samples_sam_frames():
    """The request front: IV2 and CLIP streams from all frames, the SAM
    stream from uniformly sampled ones (bench.py:99, :126-133), in the
    dtype asked for."""
    cfg = VideoGLaMMConfig.tiny(num_frames=4)
    rng = np.random.RandomState(9)
    raw = rng.randint(0, 256, size=(2, 4, 48, 85, 3)).astype(np.uint8)
    frames, ctx, sam = prepare_vision_inputs(torch.from_numpy(raw), cfg,
                                             num_sam_frames=2)
    assert frames.shape == (2, 4, 28, 28, 3) and ctx.shape == (2, 4, 56, 56, 3)
    assert sam.shape == (2, 2, 128, 128, 3)
    idx = np.linspace(0, 3, 2).astype(np.int32)
    np.testing.assert_array_equal(tpre.sample_frame_indices(4, 2), idx)
    ref = jpre.preprocess_sam_stream(jnp.asarray(raw[:, idx]), 128)
    np.testing.assert_allclose(sam.numpy(), np.asarray(ref), atol=TOL, rtol=0)
    ref_iv = jpre.preprocess_iv_stream(jnp.asarray(raw), 28)
    np.testing.assert_allclose(frames.numpy(), np.asarray(ref_iv), atol=TOL,
                               rtol=0)
    bf = prepare_vision_inputs(torch.from_numpy(raw), cfg, dtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in bf)
    assert bf[2].shape == (2, 4, 128, 128, 3)        # all frames by default
    np.testing.assert_array_equal(tpre.sample_frame_indices(2, 4), [0, 1, 1, 1])

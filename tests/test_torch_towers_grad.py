"""Training through the towers (`freeze_towers=False`) against the JAX
package on the CPU, and the Hiera window block's autograd Function.

One JAX parameter tree of `VideoGLaMMConfig.tiny()` with `lora_rank=2`,
filled from a numpy seed, is carried into the port by `io/from_jax.py`; the
batch is `make_batch` of tests/test_videoglamm.py. JAX runs its loss under
`jax.grad` with `freeze_towers=False` (no stop_gradient on the towers); the
port runs `VideoGLaMM.forward(..., freeze_towers=False)` with every
parameter asking for a gradient. Everything in f32, on the XLA references
and the plain twins (no Pallas interpret mode).

Tolerance: that of tests/test_torch_training.py for trainable leaves, 2e-4
of each leaf's largest entry plus 1e-6 absolute: a gradient sums thousands
of f32 products in another order than XLA does.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import seeded_params
from test_videoglamm import CFG, make_batch
from videoglamm_tpu import config as jconfig
from videoglamm_tpu.models import VideoGLaMM as JVideoGLaMM
from videoglamm_torch.io.from_jax import port_config, videoglamm_state_dict
from videoglamm_torch.ops import fused_block as FB
from videoglamm_torch.training import build_training
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

LORA_RANK = 2
TOL_GRAD = 2e-4
TCFG = port_config(jconfig.TrainConfig(lr=1e-3, warmup_steps=1,
                                       total_steps=10, grad_accum_steps=1,
                                       lora=jconfig.LoRAConfig(r=LORA_RANK)))
# the leaves that freeze_towers=True keeps out of the gradient
GROUPS = {"internvideo2": r"^vision_tower\.",
          "clip": r"^image_vision_tower\.",
          "projectors": r"^(image_)?mm_projector\.",
          "sam_encoder": r"^visual_model\.image_encoder\."}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v).astype(np.int64)
                                if np.asarray(v).dtype.kind == "i"
                                else np.asarray(v).copy())
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def grads():
    """(JAX gradients by port name, the port's gradients by name)."""
    jm = JVideoGLaMM(CFG, dtype=jnp.float32, lora_rank=LORA_RANK)
    batch = make_batch(np.random.RandomState(0))
    params = seeded_params(
        lambda: jm.init(jax.random.PRNGKey(0), **batch), 11)["params"]

    def loss_fn(p):
        return jm.apply({"params": p}, **batch, freeze_towers=False).loss

    jgrads = videoglamm_state_dict(jax.jit(jax.grad(loss_fn))(params), CFG)
    tr = build_training(port_config(CFG), TCFG,
                        videoglamm_state_dict(params, CFG), device="cpu",
                        dtype=torch.float32)
    tr.model.requires_grad_(True)
    out = tr.model(**_torch_batch(batch), freeze_towers=False)
    out.loss.backward()
    return jgrads, {n: p.grad for n, p in tr.model.named_parameters()}


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_tower_gradients_match_jax(grads, group):
    """Every leaf of the group against jax.grad of the JAX model's loss
    with freeze_towers=False; the group's gradient is not all zero."""
    jgrads, tgrads = grads
    names = [n for n in tgrads if re.search(GROUPS[group], n)]
    assert names
    moved = 0
    for n in names:
        want = jgrads[n].numpy()
        got = tgrads[n]
        got = np.zeros_like(want) if got is None else got.numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=TOL_GRAD * np.abs(want).max() + 1e-6,
                                   err_msg=n)
        moved += bool(np.abs(want).max() > 0)
    assert moved > 0


def _block_inputs(seed: int, NW=6, S=16, C=32):
    rng = np.random.RandomState(seed)
    shapes = {"ln1_weight": (C,), "ln1_bias": (C,), "qkv_weight": (3 * C, C),
              "qkv_bias": (3 * C,), "proj_weight": (C, C), "proj_bias": (C,),
              "ln2_weight": (C,), "ln2_bias": (C,),
              "fc1_weight": (4 * C, C), "fc1_bias": (4 * C,),
              "fc2_weight": (C, 4 * C), "fc2_bias": (C,)}
    p = {k: torch.from_numpy(
        (1.0 + 0.1 * rng.randn(*s) if k.endswith("weight") and k.startswith("ln")
         else rng.randn(*s) / (np.sqrt(s[-1]) if len(s) == 2 else 10.0))
        .astype(np.float32)) for k, s in shapes.items()}
    x = torch.from_numpy(rng.randn(NW, S, C).astype(np.float32))
    dy = torch.from_numpy(rng.randn(NW, S, C).astype(np.float32))
    return x, p, dy


@pytest.mark.parametrize("wrt", ["all", "params", "x"])
def test_fused_block_function_gradients_equal_autograd_through_the_twin(wrt):
    """`_FusedBlock` with the plain twin standing in for the kernel chain
    (a CPU tensor): the gradients of x and of the 12 block parameters that
    ask for one equal autograd through `_fused_block_ref`; the output has
    a grad_fn whenever x or a parameter asks for a gradient."""
    x, p, dy = _block_inputs(3)
    if wrt in ("all", "x"):
        x.requires_grad_(True)
    if wrt in ("all", "params"):
        for t in p.values():
            t.requires_grad_(True)
    leaves = [t for t in [x, *(p[k] for k in FB.PKEYS)] if t.requires_grad]
    y = FB.fused_window_block(x, p, 2)
    assert y.grad_fn is not None and "FusedBlock" in type(y.grad_fn).__name__
    got = torch.autograd.grad(y, leaves, dy)
    want = torch.autograd.grad(FB._fused_block_ref(x, p, 2, 1e-6), leaves, dy)
    assert len(got) == (13 if wrt == "all" else 12 if wrt == "params" else 1)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)
    with torch.no_grad():
        assert FB.fused_window_block(x, p, 2).grad_fn is None

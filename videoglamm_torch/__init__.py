"""videoglamm_torch — the PyTorch / CUDA port of videoglamm_tpu for one
NVIDIA H100 (first slice: the bf16 framewise GCG serving path).

Module names mirror videoglamm_tpu, so each module has an obvious JAX
counterpart, which stays the reference. Every Pallas kernel on the slice's
path is a hand-written Hopper kernel here: `csrc/attention_fwd.cu` (K1),
`csrc/gemm_epilogue.cu` (K2) and the Triton row norm in `ops/norms.py`
(K3). Each has a plain PyTorch twin that CPU tensors take.

This package imports torch and never jax, nor anything of videoglamm_tpu:
`config.py` and `constants.py` hold the values it needs.
"""

__version__ = "0.1.0"

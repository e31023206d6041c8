"""videoglamm_torch — the PyTorch / CUDA port of videoglamm_tpu for one
NVIDIA H100: the framewise GCG serving path from raw frames, with bf16,
int8 or int4 LLM weights and a bf16 or int8 KV cache.

Module names mirror videoglamm_tpu, so each module has an obvious JAX
counterpart, which stays the reference. Every Pallas kernel on the served
path is a hand-written Hopper kernel here: `csrc/attention_fwd.cu` (K1),
`csrc/gemm_epilogue.cu` (K2), the Triton row norm in `ops/norms.py` (K3),
`csrc/decode_attention_q8.cu` (K4, decode attention over the int8 cache)
and `csrc/dequant_gemv.cu` (K5, the int8 / int4 decode GEMV). Each has a
plain PyTorch twin that CPU tensors take.
`inference.pipeline.build_inference` builds a model for serving, on the
card unless the caller asks for the CPU.

This package imports torch and never jax, nor anything of videoglamm_tpu:
`config.py` and `constants.py` hold the values it needs.
"""

__version__ = "0.1.0"

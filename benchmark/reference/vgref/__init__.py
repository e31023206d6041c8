"""The plain reference of the benchmark: a frozen copy of the model code of
`videoglamm_torch` at commit ce28f5dd709757c114337fe8b2de89d0eb6c4ffc
(models/, models/sam2/, ops/preprocess.py, ops/resize.py, ops/rope.py,
config.py, constants.py), with tensor parallelism, Llama and the tracker
taken out, and every kernel replaced by plain torch operations in
`ops/attention.py`, `ops/norms.py`, `ops/quant.py` and `ops/fused_block.py`.
It imports nothing of `videoglamm_torch`; the benchmark runs it in f32 with
TF32 off."""

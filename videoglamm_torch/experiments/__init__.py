"""Counterparts of the JAX package's standalone experiment scripts
(`scripts/decode_mlp_experiment.py`, `scripts/bench_decode_fused.py`,
`scripts/bench_flash_bshd.py`). Nothing on a serving or training path
imports this package."""

"""Causal flash attention read straight from [B, S, H, D] tensors (PyTorch
port of scripts/bench_flash_bshd.py).

The JAX script asks whether a flash kernel whose blocks index the head axis
of a BSHD tensor beats transpose -> contiguous -> flash -> transpose back at
LLM prefill scale: `flash_bshd` (:29) wraps the body of the flash kernel
`_flash_kernel` in BlockSpecs over `[1, block, 1, D]` and reaches
`pl.pallas_call` at :61. On the card there is no second kernel to write: K1
(`csrc/attention_fwd.cu`) reads q, k, v and writes o through element
strides, so `flash_attention_bshd` launches K1 on `transpose(1, 2)` views
and has it write into a BSHD tensor. Its launches are counted under
`flash_bshd` in `ops.attention.LAUNCHES`, where K1 counts its modes.
`run_harness` is the script's `main` (:110-156): the two layouts chained
over a few layers, timed, and their largest difference.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from ..ops import attention as A


def _flash_bshd_plain(q, k, v, kv_lens, q_start, *, causal: bool,
                      sm_scale: float):
    """Twin: the plain attention on the transposed views, back in BSHD."""
    o = A._attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), causal=causal, sm_scale=sm_scale,
                           kv_lens=kv_lens, q_start=q_start)
    return o.transpose(1, 2).contiguous()


def flash_attention_bshd(q, k, v, kv_lens, q_start, *, causal: bool,
                         sm_scale: Optional[float] = None):
    """q: [B, Sq, H, D]; k/v: [B, Sk, H, D], straight from the projections
    or a token-major cache (any strides with a contiguous head dim);
    kv_lens, q_start: [B] ints. Returns a contiguous [B, Sq, H, D]. A CPU
    tensor takes the plain twin; a CUDA tensor launches K1 or raises."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return _flash_bshd_plain(q, k, v, kv_lens, q_start, causal=causal,
                                 sm_scale=float(sm_scale))
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    A.attention_fwd_kernel(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), out.transpose(1, 2),
                           causal=causal, sm_scale=float(sm_scale),
                           mode="flash_bshd", kv_lens=kv_lens, q_start=q_start)
    return out


def flash_attention_transposed(q, k, v, kv_lens, q_start, *, causal: bool,
                               sm_scale: float):
    """The layout the script calls "today" (:122-130): transpose to
    [B, H, S, D], make the three operands contiguous, run the flash entry
    and transpose back into a contiguous BSHD tensor."""
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    o = A.flash_attention(qt, kt, vt, causal=causal, kv_lens=kv_lens,
                          q_start=q_start, sm_scale=sm_scale)
    return o.transpose(1, 2).contiguous()


def run_harness(B: int = 1, H: int = 32, Sq: int = 3456, Sk: int = 3520,
                D: int = 96, layers: int = 8, reps: int = 8, seed: int = 0,
                device="cuda", dtype=torch.bfloat16, log=print) -> dict:
    """Time `layers` chained attention layers in both layouts (each layer's
    output is the next one's query, as in the script's scans) and compare
    one call of each. Returns the two times a layer in ms and the largest
    absolute difference. The time is the host clock around `reps` chains
    ending in a synchronise, so it is a device time only on a CUDA
    device."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(B, s, H, D, generator=g, device=dev).to(dtype)
               for s in (Sq, Sk, Sk))
    kv_lens = torch.full((B,), Sq, dtype=torch.int32, device=dev)
    q_start = torch.zeros(B, dtype=torch.int32, device=dev)
    sm = D ** -0.5

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def chain(fn):
        c = q
        for _ in range(layers):
            c = fn(c, k, v, kv_lens, q_start, causal=True, sm_scale=sm)
        return c

    def timeit(fn):
        chain(fn)
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            chain(fn)
        sync()
        return (time.perf_counter() - t0) / reps / layers * 1e3

    with torch.no_grad():
        t_transposed = timeit(flash_attention_transposed)
        t_bshd = timeit(flash_attention_bshd)
        o1 = flash_attention_transposed(q, k, v, kv_lens, q_start, causal=True,
                                        sm_scale=sm)
        o2 = flash_attention_bshd(q, k, v, kv_lens, q_start, causal=True,
                                  sm_scale=sm)
        sync()
    err = (o1.float() - o2.float()).abs().max().item()
    log(f"transpose + contiguous + flash [B,H,S,D]: {t_transposed:.3f} ms/layer")
    log(f"flash on BSHD views (strided loads):      {t_bshd:.3f} ms/layer")
    log(f"max |diff| of the two layouts: {err:.2e}")
    return dict(transposed_ms=t_transposed, bshd_ms=t_bshd, max_abs_diff=err)


if __name__ == "__main__":
    run_harness()

"""train_steps: optimizer steps of `Training.train_step`, one after the
other, on micro-batches made from the seed.

Set-up makes the weights on the device from the seed, builds the step
through `build_training`, and takes its first `check_steps` steps through
the same call the window makes (they warm every shape): their losses, the
first step's gradients as the optimizer took them (from its first moments)
and the trainable leaves' change over the steps are kept for the check.
The window takes whole steps until `--seconds` have passed and ends with
the step in flight; `train_positions_per_s` is the LLM positions of those
steps over the window. With --trace, every step of the window records the
program's phase clock, and two more steps after the window run under the
profiler: one with the device's activity alone (busy and idle), one with
the host's operations too (kernel times, the breakdown). Once the window has closed and the program is freed, the
reference takes the same first steps (`checks.train`)."""
from __future__ import annotations

import gc
import time

import torch

import checks
import flops as F
import harness
import workload_gen as gen
from weights import fill

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def train_config(c: dict):
    t = dict(c["mode"]["train"])
    t["lora"] = {"r": c["mode"]["lora_r"], "alpha": c["mode"]["lora_alpha"]}
    return checks.program_config(t, "TrainConfig")


def positions(c: dict, tr: dict) -> int:
    """LLM positions of one optimizer step (padded rows included)."""
    return (c["mode"]["train"]["grad_accum_steps"] * tr["rows"]
            * (tr["text_tokens"] - 1 + F.visual_tokens(c)))


def run(cell, *, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, control: bool = False) -> dict:
    c, tr = cell["config"], cell["traffic"]
    mode = c["mode"]
    accum = mode["train"]["grad_accum_steps"]
    dev = torch.device(device)
    dtype = DTYPES[mode["dtype"]]
    t0 = time.time()
    from videoglamm_torch.ops import _cuda
    from videoglamm_torch.training import build_training
    t_import = time.time() - t0
    t0 = time.time()
    if dev.type == "cuda":
        _cuda.load_all(sorted(p.stem for p in _cuda.CSRC.glob("*.cu")))
    t_kernels = time.time() - t0

    t0 = time.time()
    weights, _ = checks.seeded_weights(c, tr, seed, dev)
    tr_obj = build_training(checks.program_config(c), train_config(c),
                            device=dev, dtype=dtype,
                            init=lambda m: fill(m, weights))
    del weights
    gc.collect()
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_build = time.time() - t0

    # the first steps: the window's own call, rows of their own; they warm
    # every shape, and the check reads them
    t0 = time.time()
    state = tr_obj.state
    names = list(tr_obj.tx.trainable)
    start = {n: state.params[n].detach().clone() for n in names}
    losses, first_grad = [], None
    b1 = mode["train"]["beta1"]
    for step in range(tr["check_steps"]):
        batch = gen.train_batch(tr, c, seed, step, accum, dev, dtype)
        state, m = tr_obj.train_step(state, batch)
        losses.append(float(m["loss"]))
        if step == 0:     # the gradient the optimizer took: mu / (1 - beta1)
            first_grad = {n: float(state.opt_state["mu"][n].float().norm())
                          / (1.0 - b1) for n in names}
    change = {n: float((state.params[n].detach().float() - start[n].float()).norm())
              for n in names}
    del start
    _sync(dev)
    t_warm = time.time() - t0
    harness.log(f"set-up: import {t_import:.2f} s, kernels {t_kernels:.2f} s, "
                f"weights and build {t_build:.2f} s, first {tr['check_steps']} "
                f"steps {t_warm:.2f} s; losses {losses}")

    per_step = positions(c, tr)
    step = tr["check_steps"]
    phase_times = []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.time() - t_start
    w0 = time.perf_counter()
    n = 0
    while True:
        batch = gen.train_batch(tr, c, seed, step + n, accum, dev, dtype)
        timings = {} if trace else None
        state, m = tr_obj.train_step(state, batch, timings=timings)
        float(m["loss"])                       # the step is done
        n += 1
        if trace:
            phase_times.append(timings)
        if time.perf_counter() - w0 >= seconds:
            break
    window_s = time.perf_counter() - w0
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    harness.log(f"window: {n} steps in {window_s:.3f} s, "
                f"{n * per_step / window_s:.2f} positions/s; set-up "
                f"{setup_s:.2f} s; peak {peak / 2**30:.2f} GiB")

    layer = None
    if trace:
        from tracing import device_pass, profiled
        batch = gen.train_batch(tr, c, seed, step + n, accum, dev, dtype)
        one = lambda: tr_obj.train_step(state, batch)[1]["loss"].item()
        _, trc = profiled(one)
        _, busy = device_pass(one)
        layer = {"config": c, "traffic": tr, "phase_times": phase_times,
                 "trace": trc, "device_pass": busy, "steps": n, "window_s": window_s,
                 "positions": per_step, "peak_bytes": peak}
    del tr_obj, state, batch, m
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.time()
    check_list, ctl = checks.train(c, tr, seed, losses, first_grad, change, dev,
                              control=control)
    harness.log(f"reference over {tr['check_steps']} steps: "
                f"{time.time() - t0:.2f} s")
    return {"attempted": n, "failed": 0,
            "metrics": {"train_positions_per_s": {
                "value": n * per_step / window_s, "unit": "positions/s"},
                "setup_s": {"value": setup_s, "unit": "s"}},
            "checks": check_list, "control": ctl, "peak_bytes": peak,
            "layer": layer}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()

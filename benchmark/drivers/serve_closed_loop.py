"""serve_closed_loop: batches of clips through `GroundedInference.serve_raw`,
one after the other, with a queue that is always full.

Set-up makes the weights on the device from the seed, builds the model
through `build_inference`, and warms the cell's shapes; `setup_s` leaves
out the reference's decode that shapes the [SEG] row (`checks.seeded_weights`).
The window serves whole batches until `--seconds` have passed and ends with
the batch in flight; a request is done when its tokens and masks are on the
host. `serve_frames_per_s` is the clip frames of the done requests over the
window. With --trace, every batch of the window records the program's
stage clock, and two more batches after the window run under the profiler:
one with the device's activity alone (busy and idle), one with the host's
operations too (kernel times, stage intervals, the breakdown).
Once the window has closed and the program is freed, the reference
follows a sample of the done requests (see `check`)."""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

import checks
import harness
import workload_gen as gen
from weights import fill, sub_seed

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# stage -> (index of the sync that opens it, of the sync that closes it)
# within one serve_raw call with a stage clock: the call's clock starts
# (0), marks preprocess (1); __call__'s clock starts (2), marks visual (3),
# generate (4), sam_encode (5), mask_decode (6)
STAGE_SYNCS = {"preprocess": (0, 1), "visual": (2, 3), "generate": (3, 4),
               "sam_encode": (4, 5), "mask_decode": (5, 6)}


def run(cell, *, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, control: bool = False) -> dict:
    c, tr = cell["config"], cell["traffic"]
    mode = c["mode"]
    dev = torch.device(device)
    t0 = time.time()
    from videoglamm_torch.inference.pipeline import build_inference
    from videoglamm_torch.ops import _cuda
    t_import = time.time() - t0

    t0 = time.time()
    if dev.type == "cuda":
        _cuda.load_all(sorted(p.stem for p in _cuda.CSRC.glob("*.cu")))
    t_kernels = time.time() - t0

    t0 = time.time()
    timing = {}
    weights, seg = checks.seeded_weights(c, tr, seed, dev, timing=timing)
    t_seg = timing.get("seg_row_s", 0.0)
    t_shape = time.time() - t0 - t_seg
    cfg = checks.program_config(c)
    B, new = tr["batch"], tr["new_tokens"]
    gi = build_inference(cfg, device=dev, dtype=DTYPES[mode["dtype"]],
                         quant=mode["quant"], kv_cache=mode["kv_cache"],
                         max_new_tokens=new,
                         init=lambda m: fill(m, weights))
    del weights
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    t_build = time.time() - t0 - t_seg - t_shape

    t0 = time.time()
    serve = lambda raw, ids, lens, timings=None: gi.serve_raw(
        raw, ids, lens, num_sam_frames=tr["sam_frames"], timings=timings)
    lo, hi = tr["prompt_tokens"]
    # one batch at the longest prompt, and a prefill at the other parity
    # of the spliced length (the norm kernel specialises on it)
    for n, steps in ((hi, new), (hi - 1, 1)):
        gi.max_new_tokens = steps
        raw, ids, lens = gen.clip_batch(tr, checks.seed_of_warm(seed), 0,
                                        [n] * B, dev)
        _host(serve(raw, ids, lens))
    gi.max_new_tokens = new
    t_warm = time.time() - t0
    harness.log(f"set-up: import {t_import:.2f} s, kernels {t_kernels:.2f} s, "
                f"weights {t_shape:.2f} s, build {t_build:.2f} s, warm-up "
                f"{t_warm:.2f} s; the [SEG] row's reference decode {t_seg:.2f} s "
                f"(not in setup_s)")

    lengths = gen.prompt_lengths(tr, seed, tr["max_requests"])
    done, stage_times = [], []
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    gc.collect()
    gc.freeze()            # set-up's objects: no collection scans them again
    setup_s = time.time() - t_start - t_seg
    host = harness.HostClock()
    w0 = time.perf_counter()
    ends = []
    while True:
        k = len(done) * B
        if k + B > len(lengths):
            raise RuntimeError("the window outran the traffic's max_requests")
        raw, ids, lens = gen.clip_batch(tr, seed, k, lengths[k:k + B], dev)
        timings = {} if trace else None
        done.append(_host(serve(raw, ids, lens, timings)))
        ends.append(time.perf_counter() - w0)
        if trace:
            stage_times.append(timings)
        if ends[-1] >= seconds:
            break
    window_s = ends[-1]
    harness.log(host.report(window_s))
    harness.log("batch seconds: " + " ".join(
        f"{b - a:.3f}" for a, b in zip([0.0] + ends, ends)))
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    n_req = len(done) * B
    frames = n_req * tr["frames"]
    harness.log(f"window: {len(done)} batches, {n_req} requests in "
                f"{window_s:.3f} s, {frames / window_s:.4f} frames/s; "
                f"set-up {setup_s:.2f} s; peak {peak / 2**30:.2f} GiB")

    layer = None
    if trace:
        from tracing import device_pass, profiled, stage_intervals
        k = n_req
        raw, ids, lens = gen.clip_batch(tr, seed, k, lengths[k:k + B], dev)
        timings = {}
        _, trc = profiled(lambda: _host(serve(raw, ids, lens, timings)))
        _, busy = device_pass(lambda: _host(serve(raw, ids, lens)))
        layer = {"config": c, "traffic": tr, "stage_times": stage_times,
                 "trace": trc, "device_pass": busy,
                 "traced_lengths": lengths[k:k + B],
                 "stage_intervals": stage_intervals(trc, 7, STAGE_SYNCS),
                 "window_s": window_s, "lengths": lengths[:n_req],
                 "peak_bytes": peak}
    del gi
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    tokens = torch.cat([d[0] for d in done])
    out_len = torch.cat([d[1] for d in done])
    valid = torch.cat([d[2] for d in done])
    masks = [m for d in done for m in d[3]]
    n_seg = int((tokens == c["seg_token_idx"]).sum())
    harness.log(f"answers: {n_seg / n_req:.3f} [SEG] a request, "
                f"{float(valid.float().sum(1).mean()):.3f} mask slots a request, "
                f"{float(valid.any(1).float().mean()):.3f} of requests with one; "
                f"[SEG] of the first 24: "
                f"{(tokens == c['seg_token_idx']).sum(1)[:24].tolist()}")
    t0 = time.time()
    sample = checks.sample_requests(lengths[:n_req], tr["check_requests"],
                                    sub_seed(seed, "sample"), valid.any(dim=1))
    got = [(i, tokens[i, :int(out_len[i])], valid[i], masks[i]) for i in sample]
    check_list, ctl = checks.serve(c, tr, seed, seg, got, lengths, dev,
                                control=control)
    harness.log(f"reference over {len(sample)} requests: {time.time() - t0:.2f} s")
    return {"attempted": n_req, "failed": 0,
            "metrics": {"serve_frames_per_s": {"value": frames / window_s,
                                               "unit": "frames/s"},
                        "setup_s": {"value": setup_s, "unit": "s"}},
            "checks": check_list, "control": ctl, "peak_bytes": peak,
            "layer": layer}


def _host(res):
    """A request is done when its answer is on the host."""
    return tuple(t.cpu() for t in (res.tokens, res.lengths, res.seg_valid,
                                   res.pred_masks))

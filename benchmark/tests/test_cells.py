"""Each driver end to end on a tiny cell on the CPU: one well-formed last
line, `correct` true on a sound program and false with the timed path
broken underneath; a traced run without device records fails."""
from __future__ import annotations

from bench_cells import one_thread  # noqa: F401  (sys.path, one thread)

import json
import time

import pytest
import torch

import run
from bench_cells import SEED, serve_cell, train_cell

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def _execute(cell, capsys, trace=False, seconds=0.5):
    rc = run.execute(cell, SEED, seconds, trace, "cpu", time.time())
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if out else None)


@pytest.mark.parametrize("make, e2e", [(serve_cell, "serve_frames_per_s"),
                                       (train_cell, "train_positions_per_s")])
def test_driver_prints_one_result_line(make, e2e, capsys):
    rc, res = _execute(make(), capsys)
    assert rc == 0
    assert set(res) == KEYS
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {e2e, "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("make", [serve_cell, train_cell])
def test_traced_run_without_device_records_fails(make, capsys):
    rc, res = _execute(make(), capsys, trace=True)
    assert rc == 5 and res is None


def test_served_token_altered_is_not_correct(monkeypatch, capsys):
    """A token altered where it is produced: the third decode step's token
    is replaced by the one after it in the vocabulary."""
    from videoglamm_torch.inference import generate
    real = generate.sample_tokens
    calls = {"n": 0}

    def altered(logits, *a, **k):
        tok = real(logits, *a, **k)
        calls["n"] += 1
        return (tok + 1) % logits.shape[-1] if calls["n"] % 7 == 3 else tok

    monkeypatch.setattr(generate, "sample_tokens", altered)
    rc, res = _execute(serve_cell(), capsys)
    assert rc == 0 and res["correct"] is False
    assert res["checks"]["token_gap_sd"]["value"] > res["checks"]["token_gap_sd"]["limit"]


def test_step_that_leaves_the_state_unchanged_is_not_correct(monkeypatch, capsys):
    from videoglamm_torch.training import train_step as ts
    monkeypatch.setattr(ts.AdamW, "update_", lambda self, *a, **k: None)
    rc, res = _execute(train_cell(), capsys)
    assert rc == 0 and res["correct"] is False


def test_half_the_batch_left_out_is_not_correct(monkeypatch, capsys):
    """Each micro-step's loss over the first row alone, the mean taken over
    it: the program's forward is handed half of the rows."""
    from videoglamm_torch.models.videoglamm import VideoGLaMM
    real = VideoGLaMM.forward

    def half(self, frames, context_images, frames_sam, input_ids, text_lens,
             labels, video_idx, gt_masks, **k):
        h = input_ids.shape[0] // 2
        return real(self, frames, context_images, frames_sam, input_ids[:h],
                    text_lens[:h], labels[:h], video_idx[:h], gt_masks[:h], **k)

    monkeypatch.setattr(VideoGLaMM, "forward", half)
    rc, res = _execute(train_cell(), capsys)
    assert rc == 0 and res["correct"] is False


@pytest.mark.parametrize("make, driver, number", [
    (serve_cell, "serve_closed_loop", "token_gap_sd"),
    (train_cell, "train_steps", "grad_norm_gap")])
def test_the_control_reads_far_above_the_program(make, driver, number):
    """The control (the reference one precision step below the
    configuration: int4 LLM weights for serving, fp8 products for
    training) against the reference, beside the program's reading, at the
    tiny size; at the cells' own size PERF.md gives the readings and the
    limits set between them."""
    import harness
    out = harness.driver(driver).run(make(), seed=SEED, seconds=0.3,
                                     trace=False, device="cpu",
                                     t_start=time.time(), control=True)
    got = {n: v for n, v, _ in out["checks"]}
    ctl = {n: v for n, v, _ in out["control"]}
    assert ctl[number] > 10 * got[number] + 1e-3, (ctl, got)


# limits between the tiny cells' readings (the program's, the control's) as
# the cells' own limits lie between theirs: serving 0.0 / 0.63 and 2.7e-7 /
# 5.0e-5; training 2.8e-7 / 3.9e-4, 0.0020 / 0.157, 0.0019 / 0.079
TINY_LIMITS = {serve_cell: {"token_gap_sd": 0.2, "mask_rel_l2": 5e-6},
               train_cell: {"loss_rel": 3e-5, "grad_norm_gap": 0.03,
                            "change_norm_gap": 0.02}}


@pytest.mark.parametrize("make", [serve_cell, train_cell])
def test_the_control_in_the_programs_place_is_not_correct(make, capsys):
    """--control: the control's numbers stand in the program's and are
    judged by the same limits; the result line says not correct, while the
    program on the same limits is correct."""
    cell = make(**TINY_LIMITS[make])
    rc = run.execute(cell, SEED, 0.3, False, "cpu", time.time(), control=True)
    cap = capsys.readouterr()
    res = json.loads(cap.out.strip().splitlines()[-1])
    assert rc == 0 and res["correct"] is False, res["checks"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())
    assert "program " in cap.err
    rc, res = _execute(make(**TINY_LIMITS[make]), capsys, seconds=0.3)
    assert rc == 0 and res["correct"] is True, res["checks"]

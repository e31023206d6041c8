"""Tiny cells of the benchmark on the CPU (the flagship cells' traffic and
configuration files with VideoGLaMMConfig.tiny() sizes) and the fixture
that runs every test on one torch thread. Test modules import it first:
it puts the checkout, the benchmark and the reference on sys.path."""
from __future__ import annotations

import dataclasses
import json
import os
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH), str(BENCH / "reference")):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture(autouse=True)
def one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_config(name: str, **mode) -> dict:
    from vgref.config import VideoGLaMMConfig
    big = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    c = dataclasses.asdict(VideoGLaMMConfig.tiny())
    c.pop("llama")
    c.update(name="tiny-" + name, mode=dict(big["mode"], dtype="float32", **mode),
             limits=big["limits"])
    return c


def serve_cell(**limits) -> dict:
    c = tiny_config("videoglamm-phi3mini-sam2l-w8kv8")
    c["limits"] = dict(c["limits"], **limits)
    tr = json.loads((BENCH / "traffic" / "gcg-closed-b8.json").read_text())
    tr.update(batch=2, frames=4, height=48, width=64, sam_frames=2,
              new_tokens=6, prompt_tokens=[6, 9], prompt_ids=[1, 400],
              check_requests=3, seg_calibration=[2, 6])
    return {"workload": {"name": "tiny-serve", "chips": 1}, "config": c,
            "traffic": tr, "end_to_end": [], "per_layer": []}


def train_cell(**limits) -> dict:
    c = tiny_config("videoglamm-phi3mini-sam2l-lora8-bf16")
    c["limits"] = dict(c["limits"], **limits)
    tr = json.loads((BENCH / "traffic" / "lora-gcg-micro2.json").read_text())
    tr.update(text_tokens=12, text_lens=[12, 9], sam_frames=2, gt_size=32,
              seg_at=[5, 7], prompt_ids=[1, 400], label_from=4)
    return {"workload": {"name": "tiny-train", "chips": 1}, "config": c,
            "traffic": tr, "end_to_end": [], "per_layer": []}


SEED = 2**31 + 12345     # larger than 32 signed bits hold

"""GCG metrics over saved inference results (the port of
videoglamm_tpu/cli/eval_gcg_metrics.py; reference entry point
eval_gcg_metrics.py).

Computes: mask mIoU (greedy matching), grounded recall (IoU>=0.5 and
text-sim>=0.5), and METEOR/CIDEr: pycocoevalcap's when it is installed,
else the vendored implementations of evals/caption_metrics.py. Recall
matches phrases by token-overlap F1 unless `--bert` asks for the
reference's BERT cosine; token-overlap recall is labelled as not
comparable with published numbers. `--bert` loads `bert-base-uncased` by
name through `transformers` (the port's second import of it, beside
`cli/common.load_tokenizer`), so it needs a local copy of those weights.
No model runs on the card here: this is host numpy.

Reads the layout written by eval_gcg_infer:
  <pred_root>/<vid>/res.json + pred_masks/<obj>/*.png
  <gt_root>/<vid>/gt_masks/<obj>/*.png
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from ..evals.metrics import compute_miou, find_best_matches


def _load_mask_dir(d):
    from PIL import Image
    objs = {}
    if not os.path.isdir(d):
        return objs
    for obj in sorted(os.listdir(d)):
        odir = os.path.join(d, obj)
        frames = sorted(os.listdir(odir))
        tube = np.stack([np.asarray(Image.open(os.path.join(odir, f)))
                         > 127 for f in frames])
        objs[obj] = tube
    return objs


def token_overlap_sim(a: str, b: str) -> float:
    """Fallback text similarity: token-set F1 (used when BERT isn't
    available; plug the reference's BERT cosine via --bert)."""
    ta, tb = set(a.lower().split()), set(b.lower().split())
    if not ta or not tb:
        return 0.0
    inter = len(ta & tb)
    if inter == 0:
        return 0.0
    p, r = inter / len(tb), inter / len(ta)
    return 2 * p * r / (p + r)


def make_bert_sim():
    import torch
    from transformers import AutoModel, AutoTokenizer
    tok = AutoTokenizer.from_pretrained("bert-base-uncased")
    mdl = AutoModel.from_pretrained("bert-base-uncased")

    def sim(a, b):
        with torch.no_grad():
            ea = mdl(**tok(a, return_tensors="pt",
                           truncation=True)).last_hidden_state[0].mean(0)
            eb = mdl(**tok(b, return_tensors="pt",
                           truncation=True)).last_hidden_state[0].mean(0)
        return float(torch.nn.functional.cosine_similarity(
            ea[None], eb[None]))
    return sim


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--pred_root", required=True)
    p.add_argument("--gt_root", required=True)
    p.add_argument("--bert", action="store_true",
                   help="use BERT cosine text similarity (needs weights)")
    args = p.parse_args(argv)

    sim_fn = make_bert_sim() if args.bert else token_overlap_sim

    mious, tp, ap = [], 0, 0
    gt_caps, pred_caps = [], []
    for vid in sorted(os.listdir(args.pred_root)):
        pdir = os.path.join(args.pred_root, vid)
        res_path = os.path.join(pdir, "res.json")
        if not os.path.exists(res_path):
            continue
        res = json.load(open(res_path))
        pred = _load_mask_dir(os.path.join(pdir, "pred_masks"))
        gt = _load_mask_dir(os.path.join(args.gt_root, vid, "gt_masks"))
        if gt:
            mious.append(compute_miou(list(pred.values()),
                                      list(gt.values())))
            gt_phrases = res.get("gt_phrases", [])
            pred_phrases = res.get("pred_phrases", [])
            ap += len(gt_phrases)
            if gt_phrases and pred_phrases:
                n_g, n_p = len(gt), len(pred)
                matches = find_best_matches(
                    list(gt.values()), gt_phrases[:n_g],
                    list(pred.values()), pred_phrases[:n_p], sim_fn)
                tp += len(matches)
        gt_caps.append(res.get("gt_text", ""))
        pred_caps.append(res.get("pred_text_cleaned", ""))

    out = {
        "miou": float(np.mean(mious)) if mious else 0.0,
        "recall": tp / ap if ap else 0.0,
        "n_videos": len(mious),
    }
    if not args.bert:
        # the reference protocol matches phrases by BERT cosine
        # (eval_gcg_metrics.py:99-177); token-overlap recall is NOT
        # comparable to published numbers — label it so nobody quotes it
        out["recall_similarity"] = ("token_overlap_f1 (NOT the reference "
                                    "BERT-cosine protocol; rerun with "
                                    "--bert for comparable recall)")
        print("[warn] recall computed with token-overlap fallback — not "
              "protocol-comparable; use --bert with bert-base-uncased "
              "weights for the reference protocol", file=sys.stderr)
    else:
        out["recall_similarity"] = "bert_cosine (reference protocol)"
    gts = {i: [c] for i, c in enumerate(gt_caps)}
    rs = {i: [c] for i, c in enumerate(pred_caps)}
    try:
        # exact parity with the reference when pycocoevalcap is present
        from pycocoevalcap.meteor.meteor import Meteor
        from pycocoevalcap.cider.cider import Cider
        out["meteor"] = Meteor().compute_score(gts, rs)[0]
        out["cider"] = Cider().compute_score(gts, rs)[0]
    except ImportError:
        # self-contained implementations of the published algorithms
        from ..evals.caption_metrics import cider_d, meteor
        if gt_caps:
            out["meteor"] = meteor(gts, rs)[0]
            out["cider"] = cider_d(gts, rs)[0]
            out["caption_metrics"] = "vendored (pycocoevalcap absent)"
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()

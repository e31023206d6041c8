"""Official Ref-DAVIS-17 J&F evaluation over saved predictions (the port of
videoglamm_tpu/cli/eval_referdavis_metrics.py; reference entry point
eval_referdavis_metrics.py: db_eval_iou :147-178, f_measure :199-260,
DAVISEvaluation.evaluate :358-415). Per (video, expression): per-frame
region Jaccard J and boundary F, summarized as mean/recall/decay and the
global J&F. Host numpy; no model runs.

Layout: predictions <pred_root>/<vid>/<eid>/<frame>.png;
ground truth <gt_root>/<vid>/<eid or obj_id>/<frame>.png.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..evals.metrics import boundary_f_measure, davis_j, db_statistics


def _load_tube(d):
    from PIL import Image
    frames = sorted(f for f in os.listdir(d) if f.endswith(".png"))
    return frames, np.stack([
        np.asarray(Image.open(os.path.join(d, f))) > 127 for f in frames])


def evaluate(pred_root: str, gt_root: str) -> dict:
    j_means, f_means = [], []
    per_seq = {}
    for vid in sorted(os.listdir(pred_root)):
        vdir = os.path.join(pred_root, vid)
        if not os.path.isdir(vdir):
            continue
        for eid in sorted(os.listdir(vdir)):
            pdir = os.path.join(vdir, eid)
            gdir = os.path.join(gt_root, vid, eid)
            if not os.path.isdir(gdir):
                continue
            p_frames, pred = _load_tube(pdir)
            g_frames, gt = _load_tube(gdir)
            common = sorted(set(p_frames) & set(g_frames))
            if not common:
                continue
            pi = [p_frames.index(f) for f in common]
            gi = [g_frames.index(f) for f in common]
            pred, gt = pred[pi], gt[gi]
            if pred.shape[1:] != gt.shape[1:]:
                continue
            j = davis_j(gt, pred)
            f = np.array([boundary_f_measure(pred[t], gt[t])
                          for t in range(len(common))])
            jm, jr, jd = db_statistics(j)
            fm, fr, fd = db_statistics(f)
            per_seq[f"{vid}/{eid}"] = {
                "J-mean": jm, "J-recall": jr, "J-decay": jd,
                "F-mean": fm, "F-recall": fr, "F-decay": fd}
            j_means.append(jm)
            f_means.append(fm)

    J, F = float(np.mean(j_means)), float(np.mean(f_means))
    return {"J&F": (J + F) / 2, "J-mean": J, "F-mean": F,
            "n_sequences": len(j_means), "per_sequence": per_seq}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--pred_root", required=True)
    p.add_argument("--gt_root", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    res = evaluate(args.pred_root, args.gt_root)
    summary = {k: v for k, v in res.items() if k != "per_sequence"}
    print(json.dumps(summary, indent=2))
    if args.out:
        json.dump(res, open(args.out, "w"), indent=2)
    return res


if __name__ == "__main__":
    main()

"""CLAIR caption-quality judge (the port's copy of
videoglamm_tpu/evals/clair.py).

Behavioral contract from the reference utils/clair.py:31-60 +
eval_gcg_metrics.py:422-461: an LLM judge scores candidate-vs-reference
caption sets 0-100 with a JSON {"score", "reason"} response; per-video
scores average into the CLAIR metric.

The reference hardcodes the OpenAI API; here the judge LLM is a pluggable
callable (prompt -> str), so any hosted model (or a stub in tests) slots in.
"""
from __future__ import annotations

import json
import re
from typing import Callable, List, Optional, Sequence

_CLAIR_PROMPT = """\
You are trying to tell if a candidate set of captions is describing the \
same video as a reference set of captions.
Candidate set:
{candidate}
Reference set:
{reference}
On a precise scale from 0 to 100, how likely is it that the candidate set \
is describing the same video as the reference set? (JSON format, with a key \
"score", value between 0 and 100, and a key "reason" with a string value.)
"""


def clair_score(candidates: Sequence[str], references: Sequence[str],
                judge: Callable[[str], str]) -> Optional[dict]:
    """Score one candidate/reference caption-set pair via the judge LLM."""
    prompt = _CLAIR_PROMPT.format(
        candidate="\n".join(f"- {c}" for c in candidates),
        reference="\n".join(f"- {r}" for r in references))
    reply = judge(prompt)
    m = re.search(r"\{.*\}", reply, flags=re.DOTALL)
    if not m:
        return None
    try:
        obj = json.loads(m.group(0))
        return {"score": float(obj["score"]),
                "reason": str(obj.get("reason", ""))}
    except (ValueError, KeyError):
        return None


def clair_metric(all_candidates: Sequence[Sequence[str]],
                 all_references: Sequence[Sequence[str]],
                 judge: Callable[[str], str]) -> dict:
    """Dataset-level CLAIR (mean of per-sample scores / 100, the reference's
    aggregation)."""
    scores: List[float] = []
    for cand, ref in zip(all_candidates, all_references):
        res = clair_score(cand, ref, judge)
        if res is not None:
            scores.append(res["score"])
    mean = sum(scores) / len(scores) / 100.0 if scores else 0.0
    return {"clair": mean, "n_scored": len(scores)}

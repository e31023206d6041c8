"""Self-contained caption metrics: CIDEr-D and METEOR (the port's copy of
videoglamm_tpu/evals/caption_metrics.py; no function differs).

The reference scores GCG captions with pycocoevalcap's Meteor/Cider
(reference eval_gcg_metrics.py:400); where that package (and the METEOR
java jar) is absent, this module implements the published algorithms
directly:

- `cider_d` follows pycocoevalcap's cider_scorer semantics (Vedantam et
  al. 2015): n-grams 1..4, corpus document frequency over the reference
  captions, TF-IDF vectors, clipped cosine similarity per n, gaussian
  length penalty (sigma=6), x10 scaling.
- `meteor` is METEOR (Banerjee & Lavie 2005) with the official module
  order exact -> stem -> synonym: unigram alignment with Porter stemming
  and a WordNet synonym stage (nltk's wordnet corpus when installed, a
  vendored common-caption-vocabulary table otherwise — extend via
  register_synonyms), F_mean = 10PR/(R+9P), fragmentation penalty
  0.5*(chunks/matches)^3. The synonym-stage deviation from exact+stem is
  quantified in tests/test_evals.py::test_meteor_synonym_stage (a missed
  synonym pair costs up to ~0.65 METEOR on a 3-token caption); without
  the jar's exact WordNet snapshot scores track but are not
  bit-identical — treat cross-paper comparisons accordingly.
"""
from __future__ import annotations

import math
import re
from collections import Counter, defaultdict
from typing import Dict, List, Sequence, Tuple

_PUNCT = re.compile(r"[^\w\s']")


def tokenize(s: str) -> List[str]:
    return _PUNCT.sub(" ", s.lower()).split()


# ------------------------------------------------------------- CIDEr-D --

def _ngram_counts(tokens: Sequence[str], n_max: int = 4
                  ) -> List[Counter]:
    out = []
    for n in range(1, n_max + 1):
        out.append(Counter(tuple(tokens[i:i + n])
                           for i in range(len(tokens) - n + 1)))
    return out


def cider_d(gts: Dict, res: Dict, n_max: int = 4, sigma: float = 6.0
            ) -> Tuple[float, List[float]]:
    """gts/res: {key: [caption, ...]} / {key: [caption]} ->
    (corpus score, per-key scores)."""
    keys = sorted(gts)
    assert set(res) >= set(keys), "res missing keys"

    # document frequency over reference captions: each key's unique
    # n-grams count once
    df = [defaultdict(float) for _ in range(n_max)]
    ref_counts = {}
    for k in keys:
        per_ref = [_ngram_counts(tokenize(c), n_max) for c in gts[k]]
        ref_counts[k] = per_ref
        for n in range(n_max):
            seen = set()
            for counts in per_ref:
                seen.update(counts[n])
            for g in seen:
                df[n][g] += 1.0
    log_n = math.log(max(len(keys), 1))

    def tfidf(counts: Counter, n: int):
        vec, norm2 = {}, 0.0
        length = 0
        for g, tf in counts.items():
            idf = log_n - math.log(max(df[n][g], 1.0))
            v = tf * idf
            vec[g] = v
            norm2 += v * v
            length += tf
        return vec, math.sqrt(norm2), length

    scores = []
    for k in keys:
        hyp = _ngram_counts(tokenize(res[k][0]), n_max)
        hyp_v = [tfidf(hyp[n], n) for n in range(n_max)]
        key_score = 0.0
        for counts in ref_counts[k]:
            ref_v = [tfidf(counts[n], n) for n in range(n_max)]
            delta = float(hyp_v[0][2] - ref_v[0][2])   # unigram lengths
            for n in range(n_max):
                hvec, hnorm, _ = hyp_v[n]
                rvec, rnorm, _ = ref_v[n]
                val = 0.0
                for g, hv in hvec.items():
                    if g in rvec:
                        val += min(hv, rvec[g]) * rvec[g]
                if hnorm and rnorm:
                    val /= hnorm * rnorm
                val *= math.exp(-delta * delta / (2 * sigma * sigma))
                key_score += val
        key_score *= 10.0 / (len(ref_counts[k]) * n_max)
        scores.append(key_score)
    corpus = sum(scores) / max(len(scores), 1)
    return corpus, scores


# -------------------------------------------------------------- METEOR --

def _stem(w: str) -> str:
    try:
        from nltk.stem.porter import PorterStemmer
        return PorterStemmer().stem(w)
    except Exception:
        return w


_STEM_CACHE: Dict[str, str] = {}


def _stem_cached(w: str) -> str:
    if w not in _STEM_CACHE:
        _STEM_CACHE[w] = _stem(w)
    return _STEM_CACHE[w]


# Vendored fallback synonym pairs (common caption vocabulary) for when the
# nltk WordNet corpus is not installed — the official METEOR jar's third
# match stage uses WordNet synsets (reference scores via pycocoevalcap,
# eval_gcg_metrics.py:400). Symmetric lookup; extend via register_synonyms.
_SYNONYM_TABLE: Dict[str, set] = {}
for _group in [
    ("dog", "canine", "pup", "puppy"), ("cat", "feline", "kitten"),
    ("person", "individual", "human"), ("man", "male", "guy"),
    ("woman", "female", "lady"), ("child", "kid"), ("car", "automobile"),
    ("bike", "bicycle"), ("street", "road"), ("photo", "picture", "image"),
    ("big", "large"), ("small", "little"), ("fast", "quick", "speedy"),
    ("happy", "glad"), ("begin", "start", "commence"), ("end", "finish"),
    ("jump", "leap"), ("run", "sprint"), ("look", "watch"),
    ("talk", "speak"), ("sofa", "couch"), ("tv", "television"),
]:
    for _w in _group:
        _SYNONYM_TABLE.setdefault(_w, set()).update(
            x for x in _group if x != _w)


def register_synonyms(*groups) -> None:
    """Add synonym groups to the fallback table (each group: iterable of
    mutually-synonymous words)."""
    for group in groups:
        group = list(group)
        for w in group:
            _SYNONYM_TABLE.setdefault(w, set()).update(
                x for x in group if x != w)
            _SYN_CACHE.pop(w, None)


_SYN_CACHE: Dict[str, frozenset] = {}


def _synonyms(w: str) -> frozenset:
    """WordNet synset lemmas when the nltk corpus is installed, the
    vendored table otherwise."""
    if w in _SYN_CACHE:
        return _SYN_CACHE[w]
    syns = set(_SYNONYM_TABLE.get(w, ()))
    try:
        from nltk.corpus import wordnet
        for s in wordnet.synsets(w):
            syns.update(l.name().lower().replace("_", " ")
                        for l in s.lemmas())
        syns.discard(w)
    except Exception:
        pass
    _SYN_CACHE[w] = frozenset(syns)
    return _SYN_CACHE[w]


def _align(hyp: List[str], ref: List[str]) -> List[Tuple[int, int]]:
    """Greedy three-stage unigram alignment: exact matches, then stem
    matches, then synonym matches (the official METEOR module order:
    exact -> stem -> synonym), each ref position used once."""
    used_h, used_r = set(), set()
    pairs = []
    for stage in ("exact", "stem", "synonym"):
        for i, hw in enumerate(hyp):
            if i in used_h:
                continue
            for j, rw in enumerate(ref):
                if j in used_r:
                    continue
                if stage == "exact":
                    ok = hw == rw
                elif stage == "stem":
                    ok = _stem_cached(hw) == _stem_cached(rw)
                else:
                    ok = rw in _synonyms(hw) or hw in _synonyms(rw)
                if ok:
                    pairs.append((i, j))
                    used_h.add(i)
                    used_r.add(j)
                    break
    return sorted(pairs)


def _meteor_pair(hyp: List[str], ref: List[str]) -> float:
    pairs = _align(hyp, ref)
    m = len(pairs)
    if m == 0 or not hyp or not ref:
        return 0.0
    precision = m / len(hyp)
    recall = m / len(ref)
    fmean = 10 * precision * recall / (recall + 9 * precision)
    # chunks: maximal runs monotone and contiguous in both sentences
    chunks = 1
    for (h0, r0), (h1, r1) in zip(pairs, pairs[1:]):
        if not (h1 == h0 + 1 and r1 == r0 + 1):
            chunks += 1
    penalty = 0.5 * (chunks / m) ** 3
    return fmean * (1.0 - penalty)


def meteor(gts: Dict, res: Dict) -> Tuple[float, List[float]]:
    """gts/res: {key: [caption, ...]} / {key: [caption]} ->
    (corpus mean, per-key scores); per key takes the best reference."""
    keys = sorted(gts)
    scores = []
    for k in keys:
        hyp = tokenize(res[k][0])
        best = max((_meteor_pair(hyp, tokenize(r)) for r in gts[k]),
                   default=0.0)
        scores.append(best)
    return sum(scores) / max(len(scores), 1), scores

"""KV-cache generation with a spliced multimodal prefix (PyTorch port of
videoglamm_tpu/inference/generate.py): greedy or sampled decode, and greedy
decode with n-gram speculative decoding.

One prefill over the spliced sequence (attention on K1's causal mode), then
a decode loop over the static cache, bf16 or int8 (`model.quant_kv_int8`;
the int8 cache decodes through K4). Step i feeds the token sampled at step
i-1 at its own position and records that position's final-layer hidden
state (generate.py:126-137), so [SEG] hidden states are read exactly once.
The plain loop always runs max_new_tokens steps; slots after a stop token
are pad_id, as in the JAX scan. The speculative loop is the JAX
`lax.while_loop` as a Python loop: it ends when every row is done, which
costs one host synchronisation an iteration and no other.

The LLM is the composite's `llm`, Phi-3 or Llama-3.1: both have `embed`,
`forward_hidden`, `head` and the cached forward, and their configs name
the cache's geometry alike.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models import kvcache
from ..models.multimodal import splice_visual_prefix


class GenerateResult(NamedTuple):
    tokens: torch.Tensor          # [B, max_new] (pad after a stop token)
    hidden: torch.Tensor          # [B, max_new, D] hidden of each fed token
    lengths: torch.Tensor         # [B] tokens before the stop token
    prefill_hidden: torch.Tensor  # [B, S_prefill, D]
    prefill_len: torch.Tensor     # [B] spliced prompt lengths


# Per-LLM stop tokens (reference chat templates): Phi-3 instruct stops at
# <|endoftext|>=32000, <|assistant|>=32001, <|end|>=32007; Llama-3.1 at
# <|end_of_text|>=128001, <|eot_id|>=128009.
TERMINATORS = {
    "phi3": (32000, 32001, 32007),
    "llama3_1": (128001, 128009),
}


def terminators_for(llm_type: str, tokenizer=None) -> tuple:
    """Stop-token ids for the configured base LLM, optionally unioned with
    the tokenizer's eos_token_id (generate.py:52)."""
    ids = set(TERMINATORS.get(llm_type, TERMINATORS["phi3"]))
    if tokenizer is not None and getattr(tokenizer, "eos_token_id", None):
        ids.add(int(tokenizer.eos_token_id))
    return tuple(sorted(ids))


def _eos_tensor(eos_id, device):
    return torch.as_tensor(eos_id if isinstance(eos_id, (tuple, list))
                           else [eos_id], device=device)


def prefill(llm, visual_prefix, input_ids, text_lens, max_new_tokens: int,
            quant_kv: bool = False, slack: int = 1):
    """Splice, allocate the cache (int8 with `quant_kv`; `slack` slots past
    the prompt and the new tokens) and run the prefill. Returns
    (prefill_hidden, cache, spliced batch, logits of the last prompt
    position)."""
    B, S_text = input_ids.shape
    S_prefill = S_text - 1 + visual_prefix.shape[1]
    embeds = llm.embed(input_ids)
    sp = splice_visual_prefix(embeds, input_ids, visual_prefix, text_lens)
    cfg = llm.cfg
    nkv = getattr(llm, "cache_kv_heads", cfg.num_kv_heads)  # a rank's heads
    cache = kvcache.init_cache(cfg.num_layers, B, nkv,
                               S_prefill + max_new_tokens + slack, cfg.head_dim,
                               embeds.dtype, embeds.device, quant_kv)
    hidden_pre, cache = llm.forward_hidden(sp.embeds, sp.positions,
                                           sp.attn_lens, cache)
    bidx = torch.arange(B, device=embeds.device)
    logits = llm.head(hidden_pre[bidx, sp.attn_lens - 1])
    return hidden_pre, cache, sp, logits


def decode_step(llm, cache, tok, pos):
    """Feed tok [B] at positions pos [B]; returns (logits [B, V], hidden
    [B, D])."""
    logits, hidden, _ = llm(llm.embed(tok[:, None]), pos[:, None], pos + 1,
                            cache)
    return logits[:, -1], hidden[:, 0]


def sample_tokens(logits, temperature: float = 0.0, generator=None,
                  gumbel=None):
    """logits [B, V] -> token ids [B] (generate.py:115-118). temperature 0:
    the argmax. temperature > 0: a draw from softmax(logits / temperature)
    by the Gumbel-max rule, which is how `jax.random.categorical` draws:
    argmax(logits / temperature + g) with g standard Gumbel noise, from
    `generator` (a `torch.Generator` on the logits' device) or handed in as
    `gumbel` [B, V] (the tests hand in JAX's noise and get JAX's tokens)."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1)
    if gumbel is None:
        u = torch.rand(logits.shape, generator=generator, device=logits.device,
                       dtype=torch.float32)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return (logits.float() / temperature + gumbel).argmax(dim=-1)


@torch.no_grad()
def generate_with_prefix(model, visual_prefix, input_ids, text_lens, *,
                         max_new_tokens: int, eos_id=32000, pad_id: int = 0,
                         temperature: float = 0.0, generator=None,
                         draft_k: int = 0):
    """Greedy (temperature = 0) or sampled decode of the composite's LLM.
    eos_id: int or tuple of ints, generation stops at any of them.
    generator: the `torch.Generator` sampling draws from (seed 0 on the
    logits' device when none is given, as the JAX function defaults to
    PRNGKey(0)). draft_k >= 2 with temperature 0 takes
    `generate_speculative`: the same tokens from fewer weight-streaming
    passes."""
    if draft_k >= 2 and temperature == 0.0:
        return generate_speculative(
            model, visual_prefix, input_ids, text_lens,
            max_new_tokens=max_new_tokens, eos_id=eos_id, pad_id=pad_id,
            draft_k=draft_k)
    llm = model.llm
    dev = visual_prefix.device
    eos = _eos_tensor(eos_id, dev)
    if temperature > 0.0 and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    hidden_pre, cache, sp, logits = prefill(
        llm, visual_prefix, input_ids, text_lens, max_new_tokens,
        quant_kv=getattr(model, "quant_kv_int8", False))
    tok = sample_tokens(logits, temperature, generator)
    done = torch.isin(tok, eos)
    pos = sp.attn_lens.clone()
    toks, hiddens, dones = [], [], []
    for _ in range(max_new_tokens):
        logits, hidden = decode_step(llm, cache, tok, pos)
        toks.append(tok)
        hiddens.append(hidden)
        dones.append(done)
        nxt = torch.where(done, pad_id, sample_tokens(logits, temperature,
                                                      generator))
        done = done | torch.isin(nxt, eos)
        tok, pos = nxt, pos + 1
    was_done = torch.stack(dones, dim=1)
    tokens = torch.where(was_done, pad_id, torch.stack(toks, dim=1))
    return GenerateResult(tokens=tokens, hidden=torch.stack(hiddens, dim=1),
                          lengths=(~was_done).sum(dim=1),
                          prefill_hidden=hidden_pre, prefill_len=sp.attn_lens)


def ngram_replay_stats(tokens, draft_k: int) -> dict:
    """Replay a REAL token stream through the n-gram drafter to measure the
    accept rate speculative decoding would achieve on it (generate.py:151,
    host code copied exactly).

    Greedy verification emits exactly the plain-decode stream, so the
    accepted-draft count per iteration is a pure function of the stream
    itself: at each position, draft K-1 tokens with the same
    most-recent-bigram rule as generate_speculative's drafter and count the
    longest prefix matching the actual continuation. tokens: 1-D int
    sequence. Returns {iterations, tokens, accept_rate,
    tokens_per_iteration}; tokens_per_iteration is the factor by which the
    decode passes shrink (each iteration costs one weight-streaming forward
    whatever K is).
    """
    toks = [int(t) for t in np.asarray(tokens).reshape(-1)]
    K = int(draft_k)
    assert K >= 2
    n = len(toks)
    idx = 0          # index of last emitted token (position 0 given)
    iters = 0
    accepted = 0
    while idx < n - 1:
        # most recent earlier occurrence of the current bigram
        drafts = []
        if idx >= 1:
            a, b = toks[idx - 1], toks[idx]
            for j in range(idx - 2, -1, -1):
                if toks[j] == a and toks[j + 1] == b:
                    drafts = toks[j + 2:j + 2 + (K - 1)]
                    break
        if not drafts:
            drafts = [toks[idx]] * (K - 1)
        drafts = (drafts + [toks[idx]] * (K - 1))[:K - 1]
        n_acc = 0
        for d, actual in zip(drafts, toks[idx + 1:idx + K]):
            if d == actual:
                n_acc += 1
            else:
                break
        n_acc = min(n_acc, n - 1 - idx - 1)  # bonus token always emitted
        idx += n_acc + 1
        iters += 1
        accepted += n_acc
    emitted = idx
    return {
        "iterations": iters,
        "tokens": emitted,
        "accept_rate": accepted / max(iters * (K - 1), 1),
        "tokens_per_iteration": emitted / max(iters, 1),
    }


def _draft_rows(tokens, idx, K: int):
    """The drafter of generate.py:268-279 over a batch: for each row the
    most recent earlier occurrence of the current bigram gives the K-1
    tokens that followed it; with none, the last token repeated.
    tokens: [B, BUF]; idx: [B] index of the last valid token -> [B, K-1]."""
    B, BUF = tokens.shape
    dev = tokens.device
    bidx = torch.arange(B, device=dev)
    jpos = torch.arange(BUF, device=dev)[None]
    a = tokens[bidx, (idx - 1).clamp(min=0)]
    b = tokens[bidx, idx]
    match = (tokens == a[:, None]) & (torch.roll(tokens, -1, dims=1) == b[:, None]) \
        & (jpos + 1 < idx[:, None])
    any_m = match.any(dim=1) & (idx >= 1)
    j_sel = torch.where(match, jpos, -1).amax(dim=1)
    # the slice start is clamped so that the window fits, as
    # lax.dynamic_slice clamps it
    start = torch.where(any_m, j_sel + 2, 0).clamp(max=BUF - (K - 1))
    window = tokens.gather(1, start[:, None] + torch.arange(K - 1, device=dev)[None])
    return torch.where(any_m[:, None], window, b[:, None].expand(B, K - 1))


@torch.no_grad()
def generate_speculative(model, visual_prefix, input_ids, text_lens, *,
                         max_new_tokens: int, eos_id=32000, pad_id: int = 0,
                         draft_k: int = 4, stats: Optional[dict] = None):
    """Greedy decode with n-gram (prompt-lookup) speculative decoding
    (generate.py:203).

    A decode step streams the whole weight set whether it scores 1 token or
    K. Each iteration drafts K-1 tokens by matching the last generated
    bigram against the text generated so far, feeds [last, drafts] in ONE
    cached forward of K rows, and accepts the longest draft prefix that
    agrees with the model's own argmax: the outputs are the plain greedy
    decode's, accepted drafts cost no further weight traffic, and no draft
    model is needed.

    Rejected drafts leave stale KV entries above the accepted position;
    they are masked by kv_lens and overwritten by the next iteration's
    writes at the same slots. A row that is done keeps feeding K rows at its
    frozen position while other rows of the batch go on, so the cache has
    2K slots of slack: an indexed store must stay inside the buffer, where
    the JAX `dynamic_update_slice` clamps its start.

    stats: a dict that receives `iterations` (K-row forwards of the loop).
    """
    K = int(draft_k)
    assert K >= 2
    llm = model.llm
    dev = visual_prefix.device
    eos = _eos_tensor(eos_id, dev)
    M = max_new_tokens
    hidden_pre, cache, sp, logits = prefill(
        llm, visual_prefix, input_ids, text_lens, M,
        quant_kv=getattr(model, "quant_kv_int8", False), slack=2 * K)
    B = input_ids.shape[0]
    bidx = torch.arange(B, device=dev)
    ar = torch.arange(K, device=dev)[None]
    tok0 = logits.argmax(dim=-1)
    pos0 = sp.attn_lens

    # buffers with K + 1 slack so a full K-write at idx <= M never overflows
    BUF = M + K + 1
    tokens = torch.full((B, BUF), pad_id, dtype=torch.long, device=dev)
    tokens[:, 0] = tok0
    hidden = torch.zeros((B, BUF, hidden_pre.shape[-1]),
                         dtype=hidden_pre.dtype, device=dev)
    idx = torch.zeros(B, dtype=torch.long, device=dev)  # last valid token
    done = torch.isin(tok0, eos) | (M <= 1)

    iterations = 0
    while not bool(done.all()):          # the iteration's one host sync
        drafts = _draft_rows(tokens, idx, K)                     # [B, K-1]
        block = torch.cat([tokens[bidx, idx][:, None], drafts], dim=1)
        positions = (pos0 + idx)[:, None] + ar
        lg, h, _ = llm(llm.embed(block), positions, pos0 + idx + K, cache)
        preds = lg.argmax(dim=-1)                                # [B, K]

        match = drafts == preds[:, :-1]
        n_acc = match.long().cumprod(dim=1).sum(dim=1)           # [B] 0..K-1
        bonus = preds[bidx, n_acc]
        out_write = torch.where(ar < n_acc[:, None], F.pad(drafts, (0, 1)),
                                bonus[:, None])
        # emitted run: out_write[0..n_acc], cut at the first stop token
        stops = torch.isin(out_write, eos) & (ar <= n_acc[:, None])
        any_stop = stops.any(dim=1)
        first_stop = stops.long().argmax(dim=1)
        n_emit = torch.where(any_stop, first_stop + 1, n_acc + 1)

        # K tokens from idx + 1 and K hiddens from idx, for the rows that
        # are not done (a done row's columns are clamped into the buffer
        # and get their old values back)
        keep = done[:, None]
        cols_t = (idx[:, None] + 1 + ar).clamp(max=BUF - 1)
        cols_h = (idx[:, None] + ar).clamp(max=BUF - 1)
        tokens.scatter_(1, cols_t, torch.where(keep, tokens.gather(1, cols_t),
                                               out_write))
        cols_h = cols_h[..., None].expand(-1, -1, hidden.shape[-1])
        hidden.scatter_(1, cols_h, torch.where(keep[..., None],
                                               hidden.gather(1, cols_h),
                                               h.to(hidden.dtype)))
        idx = torch.where(done, idx, idx + n_emit)
        done = done | any_stop | (idx >= M - 1)
        iterations += 1

    # the loop computes hidden[j] only for tokens that were FED; the final
    # token (a verification bonus) never was: one epilogue step fills it, as
    # the plain decode feeds every emitted token
    last = tokens[bidx, idx]
    _, h_last, _ = llm(llm.embed(last[:, None]), (pos0 + idx)[:, None],
                       pos0 + idx + 1, cache)
    hidden[bidx, idx] = h_last[:, 0].to(hidden.dtype)

    valid = tokens[:, :M]
    stop_mask = torch.isin(valid, eos)
    lengths = torch.where(stop_mask.any(dim=1), stop_mask.long().argmax(dim=1), M)
    out_tokens = torch.where(torch.arange(M, device=dev)[None] < lengths[:, None],
                             valid, pad_id)
    if stats is not None:
        stats["iterations"] = iterations
    return GenerateResult(tokens=out_tokens, hidden=hidden[:, :M],
                          lengths=lengths, prefill_hidden=hidden_pre,
                          prefill_len=sp.attn_lens)

"""KV-cache greedy generation with a spliced multimodal prefix (PyTorch port
of the greedy, draft_k=0 path of videoglamm_tpu/inference/generate.py).

One prefill over the spliced sequence (Phi-3 attention on K1's causal
mode), then a decode loop over the static cache, bf16 or int8
(`model.quant_kv_int8`; the int8 cache decodes through K4). Step i feeds the token
sampled at step i-1 at its own position and records that position's
final-layer hidden state (generate.py:126-137), so [SEG] hidden states are
read exactly once. The loop always runs max_new_tokens steps; slots after
a stop token are pad_id, as in the JAX scan.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.multimodal import splice_visual_prefix
from ..models.phi3 import init_kv_cache


class GenerateResult(NamedTuple):
    tokens: torch.Tensor          # [B, max_new] (pad after a stop token)
    hidden: torch.Tensor          # [B, max_new, D] hidden of each fed token
    lengths: torch.Tensor         # [B] tokens before the stop token
    prefill_hidden: torch.Tensor  # [B, S_prefill, D]
    prefill_len: torch.Tensor     # [B] spliced prompt lengths


# Phi-3 instruct stops at <|endoftext|>=32000, <|assistant|>=32001, <|end|>=32007
PHI3_TERMINATORS = (32000, 32001, 32007)


def prefill(llm, visual_prefix, input_ids, text_lens, max_new_tokens: int,
            quant_kv: bool = False):
    """Splice, allocate the cache (int8 with `quant_kv`) and run the
    prefill. Returns (prefill_hidden, cache, spliced batch, logits of the
    last prompt position)."""
    B, S_text = input_ids.shape
    S_prefill = S_text - 1 + visual_prefix.shape[1]
    embeds = llm.embed(input_ids)
    sp = splice_visual_prefix(embeds, input_ids, visual_prefix, text_lens)
    cache = init_kv_cache(llm.cfg, B, S_prefill + max_new_tokens + 1,
                          dtype=embeds.dtype, device=embeds.device,
                          quant_kv=quant_kv)
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


@torch.no_grad()
def generate_with_prefix(model, visual_prefix, input_ids, text_lens, *,
                         max_new_tokens: int, eos_id=32000, pad_id: int = 0):
    """Greedy decode of the composite's LLM (sampling and speculative
    decode are not ported yet). eos_id: int or tuple of ints, generation
    stops at any of them."""
    llm = model.llm
    dev = visual_prefix.device
    eos = torch.as_tensor(eos_id if isinstance(eos_id, (tuple, list))
                          else [eos_id], device=dev)
    hidden_pre, cache, sp, logits = prefill(
        llm, visual_prefix, input_ids, text_lens, max_new_tokens,
        quant_kv=getattr(model, "quant_kv_int8", False))
    tok = logits.argmax(dim=-1)
    done = torch.isin(tok, eos)
    pos = sp.attn_lens.clone()
    toks, hiddens, dones = [], [], []
    for _ in range(max_new_tokens):
        logits, hidden = decode_step(llm, cache, tok, pos)
        toks.append(tok)
        hiddens.append(hidden)
        dones.append(done)
        nxt = torch.where(done, pad_id, logits.argmax(dim=-1))
        done = done | torch.isin(nxt, eos)
        tok, pos = nxt, pos + 1
    was_done = torch.stack(dones, dim=1)
    tokens = torch.where(was_done, pad_id, torch.stack(toks, dim=1))
    return GenerateResult(tokens=tokens, hidden=torch.stack(hiddens, dim=1),
                          lengths=(~was_done).sum(dim=1),
                          prefill_hidden=hidden_pre, prefill_len=sp.attn_lens)

"""Phi-3-mini decoder with a static KV cache (PyTorch port of the bf16 path
of videoglamm_tpu/models/phi3.py). HF Phi3ForCausalLM parameter names:
fused `qkv_proj` and `gate_up_proj`, full-head RoPE, untied lm_head.
No LoRA and no quantised weights in this slice."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Phi3Config
from ..ops.attention import dot_product_attention
from ..ops.rope import apply_rope, rope_cos_sin
from . import kvcache
from .common import RMSNorm


def init_kv_cache(cfg: Phi3Config, batch: int, max_len: int,
                  dtype=torch.bfloat16, device=None):
    return kvcache.init_cache(cfg.num_layers, batch, cfg.num_kv_heads, max_len,
                              cfg.head_dim, dtype, device)


class Phi3Attention(nn.Module):
    def __init__(self, cfg: Phi3Config):
        super().__init__()
        hd = cfg.head_dim
        self.qkv_proj = nn.Linear(cfg.hidden_size,
                                  (cfg.num_heads + 2 * cfg.num_kv_heads) * hd,
                                  bias=False)
        self.o_proj = nn.Linear(cfg.num_heads * hd, cfg.hidden_size, bias=False)


class Phi3MLP(nn.Module):
    def __init__(self, cfg: Phi3Config):
        super().__init__()
        self.gate_up_proj = nn.Linear(cfg.hidden_size, 2 * cfg.intermediate_size,
                                      bias=False)
        self.down_proj = nn.Linear(cfg.intermediate_size, cfg.hidden_size,
                                   bias=False)

    def forward(self, x):
        gate, up = self.gate_up_proj(x).chunk(2, dim=-1)
        return self.down_proj(F.silu(gate) * up)


class Phi3DecoderLayer(nn.Module):
    def __init__(self, cfg: Phi3Config):
        super().__init__()
        self.cfg = cfg
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = Phi3Attention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = Phi3MLP(cfg)

    def forward(self, x, positions, rope, cache, kv_lens, layer_idx: int,
                self_contained: bool = False):
        """x [B, S, D]; positions [B, S]; rope: (cos, sin) of the positions;
        kv_lens [B] valid KV after this block's tokens; cache: the stacked
        cache dict or None."""
        cfg = self.cfg
        B, S, _ = x.shape
        nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        qkv = self.self_attn.qkv_proj(self.input_layernorm(x))
        q, k, v = qkv.split([nh * hd, nkv * hd, nkv * hd], dim=-1)
        q = q.view(B, S, nh, hd).transpose(1, 2)
        k = k.view(B, S, nkv, hd).transpose(1, 2)
        v = v.view(B, S, nkv, hd).transpose(1, 2)
        cos, sin = rope
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if cache is not None and self_contained:
            # prefill from position 0: attend to the fresh k/v, the cache
            # is write-only (phi3.py:112-123)
            kvcache.write(cache, layer_idx, k, v, positions[:, 0])
            k_att, v_att = k, v
        elif cache is not None:
            cache, k_att, v_att = kvcache.update_and_fetch(
                cache, layer_idx, k, v, positions[:, 0])
        else:
            k_att, v_att = k, v
        if nkv != nh:
            k_att = k_att.repeat_interleave(nh // nkv, dim=1)
            v_att = v_att.repeat_interleave(nh // nkv, dim=1)
        # positions[:, 0]: absolute KV position of the first query
        o = dot_product_attention(q, k_att, v_att, causal=True, kv_lens=kv_lens,
                                  q_start=positions[:, 0])
        x = x + self.self_attn.o_proj(o.transpose(1, 2).reshape(B, S, nh * hd))
        return x + self.mlp(self.post_attention_layernorm(x))


class Phi3Model(nn.Module):
    def __init__(self, cfg: Phi3Config, vocab: int):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(vocab, cfg.hidden_size)
        self.layers = nn.ModuleList(Phi3DecoderLayer(cfg)
                                    for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)

    def forward(self, embeds, positions, kv_lens, cache=None,
                self_contained: bool = False):
        x = embeds
        # one table for every layer (the JAX scan traces it once per layer)
        rope = rope_cos_sin(positions, self.cfg.head_dim, self.cfg.rope_theta)
        for i, layer in enumerate(self.layers):
            x = layer(x, positions, rope, cache, kv_lens, i,
                      self_contained=self_contained)
        return self.norm(x), cache


class Phi3ForCausalLM(nn.Module):
    """Embedding + decoder + lm_head. `extra_vocab` rows hold added tokens
    ([SEG])."""

    def __init__(self, cfg: Phi3Config, extra_vocab: int = 0):
        super().__init__()
        self.cfg = cfg
        vocab = cfg.vocab_size + extra_vocab
        self.model = Phi3Model(cfg, vocab)
        self.lm_head = nn.Linear(cfg.hidden_size, vocab, bias=False)

    def embed(self, input_ids):
        """Negative placeholder ids (IMAGE_TOKEN_INDEX) are clamped: their
        rows get replaced by visual features."""
        return self.model.embed_tokens(input_ids.clamp(min=0))

    def forward(self, embeds, positions, kv_lens, cache=None):
        hidden, cache = self.model(embeds, positions, kv_lens, cache)
        return self.lm_head(hidden), hidden, cache

    def forward_hidden(self, embeds, positions, kv_lens, cache=None):
        """Decoder without lm_head; with a cache this is the prefill entry
        (attention on the fresh k/v, cache write-only)."""
        return self.model(embeds, positions, kv_lens, cache,
                          self_contained=cache is not None)

    def head(self, hidden):
        return self.lm_head(hidden)

"""Llama-3.1 decoder, the alternate LLM base (PyTorch port of
videoglamm_tpu/models/llama.py). HF LlamaForCausalLM parameter names, the
ones `import_llama` reads (videoglamm_tpu/io/import_torch.py:555):
separate q/k/v projections with GQA (8 KV heads), separate gate/up MLP
projections, RoPE theta 5e5 with the Llama-3.1 frequency rescaling,
RMSNorm, untied lm_head.

It has the interface of `Phi3ForCausalLM` (`embed`, `forward_hidden`,
`head`, the cached forward, `forward_ids`) and shares the KV cache with it
(`models/kvcache.py`): bf16, or int8, where a decode step hands the stacked
buffers UNREPEATED to K4, which groups the query heads over the KV heads
itself (G = 4 at head dim 128), so no repeated copy of the cache is made.
Every other attention call repeats k and v over the groups, as the JAX
module does (llama.py:98-104).

As in the JAX package this base has no quantised projections and no LoRA;
`remat` recomputes every decoder layer in the backward."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import LlamaConfig
from ..ops.attention import dot_product_attention
from ..ops.rope import apply_rope, llama31_rope_cos_sin, rope_cos_sin
from . import kvcache
from .common import RMSNorm, linear_cast


def init_llama_kv_cache(cfg: LlamaConfig, batch: int, max_len: int,
                        dtype=torch.bfloat16, device=None,
                        quant_kv: bool = False):
    return kvcache.init_cache(cfg.num_layers, batch, cfg.num_kv_heads, max_len,
                              cfg.head_dim, dtype, device, quant_kv)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        hd = cfg.head_dim
        self.q_proj = nn.Linear(cfg.hidden_size, cfg.num_heads * hd, bias=False)
        self.k_proj = nn.Linear(cfg.hidden_size, cfg.num_kv_heads * hd, bias=False)
        self.v_proj = nn.Linear(cfg.hidden_size, cfg.num_kv_heads * hd, bias=False)
        self.o_proj = nn.Linear(cfg.num_heads * hd, cfg.hidden_size, bias=False)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.gate_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size, bias=False)
        self.up_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size, bias=False)
        self.down_proj = nn.Linear(cfg.intermediate_size, cfg.hidden_size, bias=False)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    exact_f32 = False      # models.common.set_exact_f32

    def __init__(self, cfg: LlamaConfig, causal: bool = True):
        super().__init__()
        self.cfg = cfg
        self.causal = causal
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = LlamaAttention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = LlamaMLP(cfg)

    def forward(self, x, positions, rope, cache, kv_lens, layer_idx: int,
                self_contained: bool = False):
        """x [B, S, D]; positions [B, S]; rope: (cos, sin) of the positions;
        kv_lens [B] valid KV after this block's tokens; cache: the stacked
        cache dict or None."""
        cfg = self.cfg
        B, S, _ = x.shape
        nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        h = self.input_layernorm(x)
        att = self.self_attn
        q = att.q_proj(h).view(B, S, nh, hd).transpose(1, 2)
        k = att.k_proj(h).view(B, S, nkv, hd).transpose(1, 2)
        v = att.v_proj(h).view(B, S, nkv, hd).transpose(1, 2)
        cos, sin = rope
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        k_scale = v_scale = None
        if cache is not None and self_contained:
            # prefill from position 0: attend to the fresh k/v, the cache
            # is write-only (llama.py:80-88)
            kvcache.write(cache, layer_idx, k, v, positions[:, 0])
            k_att, v_att = k, v
        elif cache is not None:
            cache, k_att, v_att, k_scale, v_scale = kvcache.update_and_fetch(
                cache, layer_idx, k, v, positions[:, 0], x.dtype)
        else:
            k_att, v_att = k, v
        # GQA: the int8-cache decode passes k/v unrepeated, K4 groups the
        # heads natively (llama.py:98-104)
        if nkv != nh and k_scale is None:
            k_att = k_att.repeat_interleave(nh // nkv, dim=1)
            v_att = v_att.repeat_interleave(nh // nkv, dim=1)
        o = dot_product_attention(q, k_att, v_att, causal=self.causal,
                                  kv_lens=kv_lens, q_start=positions[:, 0],
                                  k_scale=k_scale, v_scale=v_scale,
                                  layer=layer_idx, exact=self.exact_f32)
        x = x + att.o_proj(o.transpose(1, 2).reshape(B, S, nh * hd))
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig, vocab: int,
                 use_rope_scaling: bool = True, remat: bool = False):
        super().__init__()
        self.cfg = cfg
        self.use_rope_scaling = use_rope_scaling
        self.remat = remat
        self.embed_tokens = nn.Embedding(vocab, cfg.hidden_size)
        self.layers = nn.ModuleList(LlamaDecoderLayer(cfg)
                                    for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)

    def forward(self, embeds, positions, kv_lens, cache=None,
                self_contained: bool = False):
        x = embeds
        table = llama31_rope_cos_sin if self.use_rope_scaling else rope_cos_sin
        rope = table(positions, self.cfg.head_dim, self.cfg.rope_theta)
        kv_lens = kv_lens.to(torch.int32)
        remat = self.remat and cache is None and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            if remat:
                x = checkpoint(layer, x, positions, rope, None, kv_lens, i,
                               use_reentrant=False)
            else:
                x = layer(x, positions, rope, cache, kv_lens, i,
                          self_contained=self_contained)
        return self.norm(x), cache


class LlamaForCausalLM(nn.Module):
    """Embedding + decoder + lm_head; a drop-in alternate base for the
    composite. `extra_vocab` rows hold added tokens ([SEG]). `act_dtype`:
    the dtype the embeddings are cast to where the table is an f32 master
    (None = the table's own)."""

    quant = "none"

    def __init__(self, cfg: LlamaConfig, extra_vocab: int = 0,
                 use_rope_scaling: bool = True, remat: bool = False):
        super().__init__()
        self.cfg = cfg
        vocab = cfg.vocab_size + extra_vocab
        self.model = LlamaModel(cfg, vocab, use_rope_scaling, remat)
        self.lm_head = nn.Linear(cfg.hidden_size, vocab, bias=False)
        self.act_dtype = None

    def embed(self, input_ids):
        """Negative placeholder ids (IMAGE_TOKEN_INDEX) are clamped: their
        rows get replaced by visual features."""
        e = self.model.embed_tokens(input_ids.clamp(min=0))
        return e if self.act_dtype is None else e.to(self.act_dtype)

    def forward(self, embeds, positions, kv_lens, cache=None):
        hidden, cache = self.model(embeds, positions, kv_lens, cache)
        return self.head(hidden), hidden, cache

    def forward_hidden(self, embeds, positions, kv_lens, cache=None):
        """Decoder without lm_head; with a cache this is the prefill entry
        (attention on the fresh k/v, cache write-only)."""
        return self.model(embeds, positions, kv_lens, cache,
                          self_contained=cache is not None)

    def head(self, hidden):
        return linear_cast(hidden, self.lm_head)

    def forward_ids(self, input_ids, positions, kv_lens, cache=None):
        return self(self.embed(input_ids), positions, kv_lens, cache)

"""Phi-3-mini decoder with a static KV cache (PyTorch port of
videoglamm_tpu/models/phi3.py). HF Phi3ForCausalLM parameter names: fused
`qkv_proj` and `gate_up_proj`, full-head RoPE, untied lm_head.

Weight-only quantised serving: with `quant_int8` / `quant_int4` the four
projections of every layer and the lm_head are `QDense` / `QDense4`
(int8 resp. packed int4 weights through `ops/quant.py`; decode calls run
on K5). `quantize_llm` turns a float model into that form in place. The
cache may be bf16 or int8 (`models/kvcache.py`); on the int8 cache a decode
step hands the stacked buffers, unrepeated for GQA, to K4.

Training: `lora_rank > 0` adds LoRA on the q and v slices of the fused qkv
output (`{q,v}_lora_{a,b}` on `self_attn`, B initialised to zero;
phi3.py:92-103), `remat` recomputes every decoder layer in the backward
(`torch.utils.checkpoint`, phi3.py:182-183). The trainable weights (LoRA,
embed_tokens, lm_head) may stay f32 while the rest is stored in the
compute dtype: they are cast at use (`linear_cast`, `act_dtype`)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import Phi3Config
from ..ops.attention import dot_product_attention
from ..ops.rope import apply_rope, rope_cos_sin
from . import kvcache
from .common import QDense, QDense4, RMSNorm, linear_cast

QUANT_MODES = ("none", "int8", "int4")


def init_kv_cache(cfg: Phi3Config, batch: int, max_len: int,
                  dtype=torch.bfloat16, device=None, quant_kv: bool = False):
    """quant_kv stores K/V as int8 with per-token and per-head scales
    (models/kvcache.py)."""
    return kvcache.init_cache(cfg.num_layers, batch, cfg.num_kv_heads, max_len,
                              cfg.head_dim, dtype, device, quant_kv)


def _proj(in_features: int, out_features: int, quant: str):
    """A bias-free projection in the serving mode `quant` (phi3.py:58)."""
    if quant == "int4":
        return QDense4(in_features, out_features)
    if quant == "int8":
        return QDense(in_features, out_features)
    if quant != "none":
        raise ValueError(f"quant {quant!r}: expected one of {QUANT_MODES}")
    return nn.Linear(in_features, out_features, bias=False)


class Phi3Attention(nn.Module):
    def __init__(self, cfg: Phi3Config, quant: str = "none",
                 lora_rank: int = 0, lora_alpha: float = 16.0):
        super().__init__()
        hd = cfg.head_dim
        self.qkv_proj = _proj(cfg.hidden_size,
                              (cfg.num_heads + 2 * cfg.num_kv_heads) * hd, quant)
        self.o_proj = _proj(cfg.num_heads * hd, cfg.hidden_size, quant)
        self.lora_scale = lora_alpha / lora_rank if lora_rank > 0 else 0.0
        if lora_rank > 0:
            for nm, out in (("q", cfg.num_heads * hd), ("v", cfg.num_kv_heads * hd)):
                a = nn.Linear(cfg.hidden_size, lora_rank, bias=False)
                b = nn.Linear(lora_rank, out, bias=False)
                nn.init.zeros_(b.weight)
                setattr(self, f"{nm}_lora_a", a)
                setattr(self, f"{nm}_lora_b", b)

    def lora_delta(self, h, nm: str):
        """h @ A @ B * alpha / rank for nm in ("q", "v") (phi3.py:92-99)."""
        a = linear_cast(h, getattr(self, f"{nm}_lora_a"))
        return linear_cast(a, getattr(self, f"{nm}_lora_b")) * self.lora_scale


class Phi3MLP(nn.Module):
    def __init__(self, cfg: Phi3Config, quant: str = "none"):
        super().__init__()
        self.gate_up_proj = _proj(cfg.hidden_size, 2 * cfg.intermediate_size,
                                  quant)
        self.down_proj = _proj(cfg.intermediate_size, cfg.hidden_size, quant)

    def forward(self, x):
        gate, up = self.gate_up_proj(x).chunk(2, dim=-1)
        return self.down_proj(F.silu(gate) * up)


class Phi3DecoderLayer(nn.Module):
    def __init__(self, cfg: Phi3Config, quant: str = "none",
                 lora_rank: int = 0, lora_alpha: float = 16.0):
        super().__init__()
        self.cfg = cfg
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = Phi3Attention(cfg, quant, lora_rank, lora_alpha)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = Phi3MLP(cfg, quant)

    def forward(self, x, positions, rope, cache, kv_lens, layer_idx: int,
                self_contained: bool = False):
        """x [B, S, D]; positions [B, S]; rope: (cos, sin) of the positions;
        kv_lens [B] valid KV after this block's tokens; cache: the stacked
        cache dict or None."""
        cfg = self.cfg
        B, S, _ = x.shape
        nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        h = self.input_layernorm(x)
        qkv = self.self_attn.qkv_proj(h)
        q, k, v = qkv.split([nh * hd, nkv * hd, nkv * hd], dim=-1)
        if self.self_attn.lora_scale:
            q = q + self.self_attn.lora_delta(h, "q")
            v = v + self.self_attn.lora_delta(h, "v")
        q = q.view(B, S, nh, hd).transpose(1, 2)
        k = k.view(B, S, nkv, hd).transpose(1, 2)
        v = v.view(B, S, nkv, hd).transpose(1, 2)
        cos, sin = rope
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        k_scale = v_scale = None
        if cache is not None and self_contained:
            # prefill from position 0: attend to the fresh k/v, the cache
            # (bf16 or int8) is write-only (phi3.py:112-123)
            kvcache.write(cache, layer_idx, k, v, positions[:, 0])
            k_att, v_att = k, v
        elif cache is not None:
            cache, k_att, v_att, k_scale, v_scale = kvcache.update_and_fetch(
                cache, layer_idx, k, v, positions[:, 0], x.dtype)
        else:
            k_att, v_att = k, v
        # GQA: the int8-cache path passes k/v unrepeated; the attention
        # groups the heads itself (phi3.py:136-142)
        if nkv != nh and k_scale is None:
            k_att = k_att.repeat_interleave(nh // nkv, dim=1)
            v_att = v_att.repeat_interleave(nh // nkv, dim=1)
        # positions[:, 0]: absolute KV position of the first query
        o = dot_product_attention(q, k_att, v_att, causal=True, kv_lens=kv_lens,
                                  q_start=positions[:, 0], k_scale=k_scale,
                                  v_scale=v_scale, layer=layer_idx)
        x = x + self.self_attn.o_proj(o.transpose(1, 2).reshape(B, S, nh * hd))
        return x + self.mlp(self.post_attention_layernorm(x))


class Phi3Model(nn.Module):
    def __init__(self, cfg: Phi3Config, vocab: int, quant: str = "none",
                 remat: bool = False, lora_rank: int = 0,
                 lora_alpha: float = 16.0):
        super().__init__()
        self.cfg = cfg
        self.remat = remat
        self.embed_tokens = nn.Embedding(vocab, cfg.hidden_size)
        self.layers = nn.ModuleList(
            Phi3DecoderLayer(cfg, quant, lora_rank, lora_alpha)
            for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)

    def forward(self, embeds, positions, kv_lens, cache=None,
                self_contained: bool = False):
        x = embeds
        # one table for every layer (the JAX scan traces it once per layer),
        # and one int32 copy of kv_lens, the type the K1 and K4 launchers read
        rope = rope_cos_sin(positions, self.cfg.head_dim, self.cfg.rope_theta)
        kv_lens = kv_lens.to(torch.int32)
        # remat: keep only each layer's input and recompute the layer in the
        # backward (phi3.py:182-183); only where a gradient is recorded
        remat = self.remat and cache is None and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            if remat:
                x = checkpoint(layer, x, positions, rope, None, kv_lens, i,
                               use_reentrant=False)
            else:
                x = layer(x, positions, rope, cache, kv_lens, i,
                          self_contained=self_contained)
        return self.norm(x), cache


class Phi3ForCausalLM(nn.Module):
    """Embedding + decoder + lm_head. `extra_vocab` rows hold added tokens
    ([SEG]). `quant_int8` / `quant_int4` build the projections and the
    lm_head in weight-only quantised form (phi3.py:224-243). `remat`,
    `lora_rank` and `lora_alpha` are the training options; LoRA does not
    combine with a quantised LLM. `act_dtype`: the dtype the embeddings are
    cast to where the embedding table is an f32 master (None = the
    table's own)."""

    def __init__(self, cfg: Phi3Config, extra_vocab: int = 0,
                 quant_int8: bool = False, quant_int4: bool = False,
                 remat: bool = False, lora_rank: int = 0,
                 lora_alpha: float = 16.0):
        super().__init__()
        self.cfg = cfg
        self.quant = "int4" if quant_int4 else "int8" if quant_int8 else "none"
        if lora_rank > 0 and self.quant != "none":
            raise ValueError("LoRA needs a float LLM (quant 'none')")
        vocab = cfg.vocab_size + extra_vocab
        self.model = Phi3Model(cfg, vocab, self.quant, remat, lora_rank,
                               lora_alpha)
        self.lm_head = _proj(cfg.hidden_size, vocab, self.quant)
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
        if self.quant != "none":
            return self.lm_head(hidden)
        return linear_cast(hidden, self.lm_head)


_QUANT_PROJS = ("self_attn.qkv_proj", "self_attn.o_proj", "mlp.gate_up_proj",
                "mlp.down_proj")


@torch.no_grad()
def quantize_llm(llm: Phi3ForCausalLM, mode: str = "int8") -> Phi3ForCausalLM:
    """Float Phi3ForCausalLM -> weight-only int8 / int4 serving form, in
    place (counterpart of `quantize_phi3_params` / `_int4` and of
    `quantize_videoglamm_llm`, videoglamm_tpu/io/import_torch.py:618-665;
    pass the composite's `.llm`): the four projections of
    every layer and the lm_head are replaced by `QDense` / `QDense4` built
    from the float weights; embeddings and norms stay float."""
    if mode not in ("int8", "int4"):
        raise ValueError(f"quantize_llm: mode {mode!r}")
    if llm.quant != "none":
        raise ValueError(f"quantize_llm: the model is already {llm.quant}")
    make = QDense.from_linear if mode == "int8" else QDense4.from_linear
    for layer in llm.model.layers:
        for name in _QUANT_PROJS:
            parent, attr = name.split(".")
            sub = getattr(layer, parent)
            setattr(sub, attr, make(getattr(sub, attr)))
    llm.lm_head = make(llm.lm_head)
    llm.quant = mode
    return llm

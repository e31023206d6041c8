"""Partitioning rules and the sharding of a model's parameters over the
`model` axis (PyTorch port of videoglamm_tpu/parallel/partitioning.py).

A spec is a tuple with one entry per dim of the parameter, the axis name
where that dim is split and None elsewhere; `()` is replicated. The rule
table is JAX's `_RULES` written over the port's names, which are the
reference checkpoint's keys in `nn.Linear`'s [out, in] orientation: JAX's
P(None, model) on a [in, out] kernel is dim 0 here, its P(model, None) is
dim 1 (a convolution's [out, in, ...] weight alike), and embed_tokens is
dim 0 in both. As in JAX the first rule that matches wins, so the bare
`proj` of the second rule catches Phi-3's gate_up_proj and down_proj
before the MLP rules do: both are split along their input dim.

`shard_params` keeps each split parameter as this rank's shard:

- Phi-3's decoder layers compute on their shards (Megatron-style tensor
  parallelism): qkv_proj is split by heads (this rank's heads of q, k and
  v), o_proj by the same heads along its input, with an all-reduce of the
  output; gate_up_proj and down_proj are split along their inputs (the
  hidden dim, resp. the intermediate dim), each with an all-reduce of its
  output. A vocabulary that divides makes embed_tokens vocab-parallel
  (masked lookup, all-reduce) and lm_head column-parallel (logits
  all-gathered). The attention and the KV cache hold this rank's heads.
- Every other split parameter (the towers, the projectors, SAM-2,
  text_hidden_fcs) is stored as its shard and gathered over the model
  group into the full weight while its top module runs
  (`collectives.gather_shard`, whose backward keeps this rank's part of
  the gradient): those modules compute on full weights, as they do on one
  card.

A parameter whose split does not divide stays replicated, as `with_sharding`
falls back in JAX; a Phi-3 attention whose head counts, or an MLP whose
widths, do not divide by the axis stays replicated as a whole.
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from .collectives import all_gather, gather_shard
from .mesh import MODEL_AXIS, Axis, Mesh

# (regex over the port's parameter name, the dim split over `model`).
# First match wins. Rules 1 to 6 are JAX's; the projector and
# text_hidden_fcs rows name the leaves that JAX's `fc1` matches under
# names the port does not share (`mlp.layers.0` likewise), and the patch
# embeddings, which JAX keeps under names no rule matches, are left out.
_RULES = (
    (r"(q_proj|k_proj|v_proj|qkv|qkv_proj|query|key|value)\.weight$", 0),
    (r"(?<!patch_embed\.)(o_proj|out_proj|proj|attn_out)\.weight$", 1),
    (r"(gate_up_proj|up_proj|gate_proj|fc1|lin1|w1|w3|mlp\.layers\.0)\.weight$", 0),
    (r"(down_proj|fc2|lin2|w2|mlp\.layers\.1)\.weight$", 1),
    (r"embed_tokens\.weight$", 0),
    (r"lm_head\.weight$", 0),
    (r"^(image_)?mm_projector\.2\.weight$", 0),
    (r"^text_hidden_fcs\.0\.2\.weight$", 0),
)


def _spec_for(name: str, ndim: int) -> tuple:
    for pat, dim in _RULES:
        if re.search(pat, name) and ndim >= 2:
            spec = [None] * ndim
            spec[dim] = MODEL_AXIS
            return tuple(spec)
    return ()


def split_dim(spec: tuple) -> Optional[int]:
    """The dim a spec splits over `model`, or None."""
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def _shapes(params) -> Dict[str, tuple]:
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    return {n: tuple(p.shape) for n, p in params.items()}


def _divisible(shape, spec, mesh: Mesh) -> bool:
    return all(axis is None or dim % mesh.shape[axis] == 0
               for dim, axis in zip(shape, spec))


def _phi3_layers(model):
    """(prefix, layer) of every Phi-3 decoder layer of a VideoGLaMM or a
    Phi3ForCausalLM; empty for anything else."""
    from ..models.phi3 import Phi3ForCausalLM
    llm, pre = (model, "") if isinstance(model, Phi3ForCausalLM) else \
        (getattr(model, "llm", None), "llm.")
    if not isinstance(llm, Phi3ForCausalLM):
        return None, []
    return llm, [(f"{pre}model.layers.{i}.", layer)
                 for i, layer in enumerate(llm.model.layers)]


def param_partition_spec(params, mesh: Optional[Mesh] = None) -> Dict[str, tuple]:
    """{name: spec} for a module or a mapping of named parameters. Without
    a mesh: the rule table alone (JAX's `param_partition_spec`). With one:
    specs that do not divide become (), as `make_sharded_train_step` makes
    them safe in JAX, and for a Phi-3 model a layer's attention is split
    only where both head counts divide and its MLP only where both of its
    widths do."""
    shapes = _shapes(params)
    specs = {n: _spec_for(n, len(s)) for n, s in shapes.items()}
    if mesh is None:
        return specs
    specs = {n: (s if _divisible(shapes[n], s, mesh) else ())
             for n, s in specs.items()}
    if isinstance(params, nn.Module):
        llm, layers = _phi3_layers(params)
        M = mesh.shape[MODEL_AXIS]
        for pre, layer in layers:
            cfg = llm.cfg
            att = (pre + "self_attn.qkv_proj.weight", pre + "self_attn.o_proj.weight")
            mlp = (pre + "mlp.gate_up_proj.weight", pre + "mlp.down_proj.weight")
            if cfg.num_heads % M or cfg.num_kv_heads % M \
                    or not all(specs.get(n) for n in att):
                specs.update({n: () for n in att if n in specs})
            if not all(specs.get(n) for n in mlp):
                specs.update({n: () for n in mlp if n in specs})
    return specs


class Sharding:
    """How one parameter is split over an axis: along `dim`, each of the
    `segments` (sizes along dim of the full tensor, which sum to it) cut
    into `axis.size` equal parts, this rank's part of every segment kept
    side by side. One segment is a plain contiguous split; Phi-3's fused
    qkv_proj has three (q, k, v), so a rank holds its heads of each."""

    def __init__(self, dim: int, segments: Sequence[int], axis: Axis):
        self.dim, self.segments, self.axis = dim, tuple(segments), axis
        if any(s % axis.size for s in self.segments):
            raise ValueError(f"segments {self.segments} do not divide by "
                             f"{axis.size}")

    def take(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the full tensor (a new tensor)."""
        n, i, d = self.axis.size, self.axis.index, self.dim
        parts = [seg.narrow(d, i * (seg.shape[d] // n), seg.shape[d] // n)
                 for seg in full.split(self.segments, dim=d)]
        return torch.cat(parts, dim=d)

    def unshard(self, local: torch.Tensor) -> torch.Tensor:
        """The full tensor from every rank's shard (an all-gather over the
        axis)."""
        d = self.dim
        every = all_gather(local, self.axis).unbind(0)
        pieces = [s // self.axis.size for s in self.segments]
        out = []
        for j, size in enumerate(pieces):
            off = sum(pieces[:j])
            out.extend(t.narrow(d, off, size) for t in every)
        return torch.cat(out, dim=d)


def _install_gather(root: nn.Module, entries):
    """While `root` runs, its split parameters are the gathered full
    weights; the stored shards are put back after."""
    inner = root.forward

    def forward(*args, **kwargs):
        saved = []
        try:
            for mod, attr, sh in entries:
                p = mod._parameters[attr]
                saved.append((mod, attr, p))
                mod._parameters[attr] = gather_shard(p, sh)
            return inner(*args, **kwargs)
        finally:
            for mod, attr, p in saved:
                mod._parameters[attr] = p

    root.forward = forward


def _gather_root(name: str) -> str:
    """The module whose run a gathered weight lives for: the composite's
    child, or its grandchild under visual_model (SAM-2's image encoder,
    mask decoder, memory encoder and attention are called apart) and
    text_hidden_fcs (a ModuleList)."""
    parts = name.split(".")
    deep = parts[0] in ("visual_model", "text_hidden_fcs")
    return ".".join(parts[:2] if deep else parts[:1])


def shard_params(model: nn.Module, mesh: Mesh) -> Dict[str, Sharding]:
    """Keep this rank's shard of every parameter that
    `param_partition_spec(model, mesh)` splits, set Phi-3's layers to
    compute on their shards and the other modules to gather theirs at use
    (module docstring). Returns {name: Sharding} of the split parameters,
    also kept as `model.shardings`; `model.mesh` is the mesh. A model whose
    LLM is quantised, or is the Llama base, raises NotImplementedError over
    a model axis above 1; over `data` alone nothing is split."""
    model.mesh = mesh
    model.shardings = {}
    axis = mesh.axis(MODEL_AXIS)
    if axis.size == 1:
        return model.shardings
    llm = getattr(model, "llm", model)
    if getattr(llm, "quant", "none") != "none":
        raise NotImplementedError(
            f"shard_params: a {llm.quant} LLM over model={axis.size} (the "
            "quantised projections have no tensor-parallel form; ROADMAP.md "
            "Queue 1 item 9, 'quantised LLM over the model axis'); serve it "
            "over data alone")
    if getattr(model.cfg, "llm_type", "phi3") != "phi3":
        raise NotImplementedError(
            f"shard_params: the {model.cfg.llm_type} base over "
            f"model={axis.size} (ROADMAP.md Queue 1 item 9, 'Llama over the "
            "model axis')")
    specs = param_partition_spec(model, mesh)
    layout: Dict[str, Sharding] = {}
    phi3, layers = _phi3_layers(model)
    if phi3 is not None:
        cfg = phi3.cfg
        hd, nh, nkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
        for pre, layer in layers:
            if specs[pre + "self_attn.qkv_proj.weight"]:
                layout[pre + "self_attn.qkv_proj.weight"] = Sharding(
                    0, (nh * hd, nkv * hd, nkv * hd), axis)
                layout[pre + "self_attn.o_proj.weight"] = Sharding(
                    1, (nh * hd,), axis)
                layer.self_attn.tp = axis
                phi3.cache_kv_heads = nkv // axis.size
            if specs[pre + "mlp.gate_up_proj.weight"]:
                layout[pre + "mlp.gate_up_proj.weight"] = Sharding(
                    1, (cfg.hidden_size,), axis)
                layout[pre + "mlp.down_proj.weight"] = Sharding(
                    1, (cfg.intermediate_size,), axis)
                layer.mlp.tp = axis
        pre = layers[0][0].split("model.layers.")[0]
        emb, head = pre + "model.embed_tokens.weight", pre + "lm_head.weight"
        vocab = phi3.model.embed_tokens.weight.shape[0]
        if specs[emb] and specs[head]:
            layout[emb] = Sharding(0, (vocab,), axis)
            layout[head] = Sharding(0, (vocab,), axis)
            phi3.vocab_tp = axis
    tp_names = set(layout)
    roots: Dict[str, list] = {}
    for name, spec in specs.items():
        if spec and name not in tp_names:
            dim = split_dim(spec)
            layout[name] = Sharding(dim, (_shape_of(model, name)[dim],), axis)
            roots.setdefault(_gather_root(name), []).append(name)
    for name, sh in layout.items():
        mod, attr = _owner(model, name)
        p = mod._parameters[attr]
        with torch.no_grad():
            shard = nn.Parameter(sh.take(p.detach()).clone(),
                                 requires_grad=p.requires_grad)
        mod._parameters[attr] = shard
    for root, names in roots.items():
        _install_gather(model.get_submodule(root),
                        [(*_owner(model, n), layout[n]) for n in names])
    model.shardings = layout
    return layout


def _owner(model: nn.Module, name: str):
    mod, _, attr = name.rpartition(".")
    return model.get_submodule(mod), attr


def _shape_of(model: nn.Module, name: str) -> tuple:
    mod, attr = _owner(model, name)
    return tuple(mod._parameters[attr].shape)


def with_sharding(x: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous shard of `x` under `spec`, or `x` itself
    where the spec does not divide (JAX's fallback to replication)."""
    d = split_dim(spec)
    if d is None or not _divisible(tuple(x.shape), spec, mesh):
        return x
    return Sharding(d, (x.shape[d],), mesh.axis(MODEL_AXIS)).take(x)


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """{name: the full tensor} of a sharded model's parameters: every split
    one gathered over the model axis. Every rank of the model group takes
    part."""
    layout = getattr(model, "shardings", {})
    return {n: (layout[n].unshard(p.detach()) if n in layout else p.detach())
            for n, p in model.named_parameters()}

"""The generation layer of videoglamm_torch against the JAX package on the
CPU: `ngram_replay_stats`, `generate_speculative` (tokens and lengths equal,
hidden states close), sampling, the stop tokens, and the pipeline's options.

A tiny Phi-3 is shaped by `jax.eval_shape`, filled from a numpy seed and
carried into the port through `io/from_jax.py`; the visual prefix and the
prompt ids come from numpy too. Everything runs in f32. Free-running greedy
tokens are compared here, against the rule for bf16 models on the card,
because speculative decoding's contract IS the token stream: in f32 on one
machine the two frameworks' logits differ by 1e-5 while the seeded model's
best and second-best logits lie far further apart.

Tolerance: 2e-4 on the hidden states of valid positions, the JAX test's own
(tests/test_inference.py:130-163): a K-row forward and K single-row
forwards sum in other orders. The int8 cache is held to 2e-3: a stored
value that lies on a rounding tie may take the neighbouring code in one of
the two frameworks, which moves that entry by 1/127 of its row's maximum.
"""
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import seeded_params
from videoglamm_tpu.config import VideoGLaMMConfig
from videoglamm_tpu.constants import IMAGE_TOKEN_INDEX
from videoglamm_tpu.inference import generate as jgen
from videoglamm_tpu.models import VideoGLaMM as JVideoGLaMM
from videoglamm_torch.inference import generate as tgen
from videoglamm_torch.inference.pipeline import GroundedInference, build_inference
from videoglamm_torch.io.from_jax import phi3_state_dict, port_config
from videoglamm_torch.models.phi3 import Phi3ForCausalLM
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CFG = VideoGLaMMConfig.tiny(num_frames=4)
B, S_TEXT, V = 2, 10, 12
M = 12
NEVER = 99999


class _Composite:
    """What generation reads of the composite: its LLM, its config and the
    cache kind."""

    def __init__(self, llm, quant_kv_int8):
        self.llm, self.cfg, self.quant_kv_int8 = llm, port_config(CFG), quant_kv_int8


def _inputs():
    rng = np.random.RandomState(0)
    visual = rng.randn(B, V, CFG.llm.hidden_size).astype(np.float32)
    ids = rng.randint(1, 400, size=(B, S_TEXT)).astype(np.int32)
    ids[:, 2] = IMAGE_TOKEN_INDEX
    lens = np.array([S_TEXT, S_TEXT - 3], np.int32)
    return visual, ids, lens


@pytest.fixture(scope="module")
def setup():
    visual, ids, lens = _inputs()
    jm = JVideoGLaMM(CFG, dtype=jnp.float32)
    pos = np.broadcast_to(np.arange(S_TEXT), (B, S_TEXT))

    def touch_llm(mdl, ids_, pos_, lens_):
        return mdl.llm.forward_ids(ids_, pos_, lens_)

    params = seeded_params(
        lambda: jm.init(jax.random.PRNGKey(0), np.maximum(ids, 0), pos, lens,
                        method=touch_llm), 11)
    llm = Phi3ForCausalLM(port_config(CFG.llm), extra_vocab=1).eval()
    llm.load_state_dict(phi3_state_dict(params["params"]["llm"]))
    tin = [torch.from_numpy(a) for a in (visual, ids.astype(np.int64),
                                         lens.astype(np.int64))]
    return params, llm, (visual, ids, lens), tin


@functools.lru_cache(maxsize=None)
def _jax_model(quant_kv: bool):
    return JVideoGLaMM(CFG, dtype=jnp.float32, quant_kv_int8=quant_kv)


_PLAIN = {}


def _jax_plain(setup, quant_kv: bool, eos):
    """The JAX plain greedy decode, once per (cache kind, terminator)."""
    key = (quant_kv, eos)
    if key not in _PLAIN:
        params, _, (visual, ids, lens), _ = setup
        _PLAIN[key] = jgen.generate_with_prefix(
            _jax_model(quant_kv), params, visual, ids, lens, max_new_tokens=M,
            eos_id=eos)
    return _PLAIN[key]


def _hitting_eos(setup, quant_kv: bool):
    """A terminator that the seeded model does emit: the fourth token of
    row 0's unterminated stream (rows then stop at different lengths)."""
    ref = _jax_plain(setup, quant_kv, NEVER)
    return int(np.asarray(ref.tokens)[0, 3])


def _same_result(got, ref, tol):
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    valid = (np.arange(M)[None, :, None]
             < np.asarray(ref.lengths)[:, None, None])
    np.testing.assert_allclose(got.hidden.numpy() * valid,
                               np.asarray(ref.hidden) * valid, atol=tol, rtol=tol)
    np.testing.assert_array_equal(got.prefill_len.numpy(),
                                  np.asarray(ref.prefill_len))


@pytest.mark.parametrize("hit", [False, True], ids=["never", "hits"])
@pytest.mark.parametrize("K", [2, 4])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_generate_speculative_matches_jax(setup, kv, K, hit):
    params, llm, (visual, ids, lens), tin = setup
    quant_kv = kv == "int8"
    eos = _hitting_eos(setup, quant_kv) if hit else NEVER
    ref = jgen.generate_speculative(_jax_model(quant_kv), params, visual, ids,
                                    lens, max_new_tokens=M, eos_id=eos,
                                    draft_k=K)
    stats = {}
    got = tgen.generate_speculative(_Composite(llm, quant_kv), *tin,
                                    max_new_tokens=M, eos_id=eos, draft_k=K,
                                    stats=stats)
    _same_result(got, ref, 2e-3 if quant_kv else 2e-4)
    assert 1 <= stats["iterations"] <= M
    if hit:
        assert int(got.lengths[0]) == 3 and (got.tokens[0, 3:] == 0).all()
    # and the port's own plain greedy: the same stream
    plain = tgen.generate_with_prefix(_Composite(llm, quant_kv), *tin,
                                      max_new_tokens=M, eos_id=eos)
    assert torch.equal(got.tokens, plain.tokens)
    assert torch.equal(got.lengths, plain.lengths)
    _same_result(plain, _jax_plain(setup, quant_kv, eos),
                 2e-3 if quant_kv else 2e-4)


def test_generate_with_prefix_routes_draft_k(setup):
    """draft_k >= 2 with temperature 0 is the speculative loop; a tuple of
    terminators stops at any of them."""
    _, llm, _, tin = setup
    eos = (NEVER, _hitting_eos(setup, False))
    a = tgen.generate_with_prefix(_Composite(llm, False), *tin,
                                  max_new_tokens=M, eos_id=eos, draft_k=3)
    b = tgen.generate_speculative(_Composite(llm, False), *tin,
                                  max_new_tokens=M, eos_id=eos, draft_k=3)
    c = tgen.generate_with_prefix(_Composite(llm, False), *tin,
                                  max_new_tokens=M, eos_id=eos)
    assert torch.equal(a.tokens, b.tokens) and torch.equal(a.tokens, c.tokens)
    assert int(a.lengths[0]) == 3
    one = tgen.generate_speculative(_Composite(llm, False), *tin,
                                    max_new_tokens=1, eos_id=NEVER, draft_k=4)
    assert one.tokens.shape == (B, 1) and torch.equal(one.tokens[:, 0],
                                                      c.tokens[:, 0])


def test_draft_rows_match_jax_drafter():
    """The batched drafter against the replay's rule on rows with a bigram
    match, without one, and at index 0."""
    toks = torch.tensor([[5, 6, 7, 8, 5, 6, 0, 0, 0, 0],
                         [1, 2, 3, 4, 9, 9, 0, 0, 0, 0],
                         [4, 0, 0, 0, 0, 0, 0, 0, 0, 0]])
    idx = torch.tensor([5, 4, 0])
    got = tgen._draft_rows(toks, idx, 4)
    assert got.tolist() == [[7, 8, 5], [9, 9, 9], [4, 4, 4]]


STREAMS = {
    "scaffold": sum(([*ph, 90, 91, 92, 93] for ph in
                     [[10, 11, 12], [20, 21], [30, 31, 32, 33]] * 3), []),
    "random": list(range(100)),
    "constant": [7] * 40,
}


@pytest.mark.parametrize("name", list(STREAMS))
@pytest.mark.parametrize("K", [2, 4])
def test_ngram_replay_stats_equal_jax(name, K):
    """The three streams of tests/test_inference.py:166."""
    assert tgen.ngram_replay_stats(STREAMS[name], K) == \
        jgen.ngram_replay_stats(STREAMS[name], K)
    assert tgen.ngram_replay_stats(torch.tensor(STREAMS[name]), K)["tokens"] \
        == len(STREAMS[name]) - 1


@pytest.mark.parametrize("llm_type", ["phi3", "llama3_1", "other"])
def test_terminators_for(llm_type):
    class Tok:
        eos_token_id = 7

    assert tgen.terminators_for(llm_type) == jgen.terminators_for(llm_type)
    assert tgen.terminators_for(llm_type, Tok()) == \
        jgen.terminators_for(llm_type, Tok())
    assert tgen.TERMINATORS == jgen.TERMINATORS


def test_sampling_follows_softmax():
    """20,000 draws from one 8-way row at temperature 0.7 against
    softmax(lg / T): every frequency within four standard deviations."""
    n, T = 20000, 0.7
    lg = torch.tensor([0.3, -1.2, 2.0, 0.0, 1.1, -0.4, 0.9, -2.5])
    g = torch.Generator().manual_seed(5)
    toks = tgen.sample_tokens(lg.expand(n, 8), T, g)
    p = torch.softmax(lg / T, dim=0).double()
    freq = torch.bincount(toks, minlength=8).double() / n
    sigma = (p * (1 - p) / n).sqrt()
    assert ((freq - p).abs() <= 4 * sigma).all(), (freq, p)
    # temperature 0 is the argmax, whatever the generator
    assert (tgen.sample_tokens(lg.expand(4, 8), 0.0, g) == 2).all()


@pytest.mark.parametrize("T", [0.7, 1.3])
def test_sampling_with_jax_noise_gives_jax_tokens(T):
    """With the Gumbel noise of `jax.random.gumbel(key, ...)` handed in, the
    tokens of `jax.random.categorical(key, lg / T)`."""
    rng = np.random.RandomState(2)
    lg = rng.randn(64, 513).astype(np.float32) * 2
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax.random.categorical(key, jnp.asarray(lg) / T, axis=-1))
    noise = np.asarray(jax.random.gumbel(key, lg.shape, jnp.float32))
    got = tgen.sample_tokens(torch.from_numpy(lg), T,
                             gumbel=torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampled_generation_is_seeded(setup):
    _, llm, _, tin = setup
    comp = _Composite(llm, False)

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return tgen.generate_with_prefix(comp, *tin, max_new_tokens=M,
                                         eos_id=NEVER, temperature=0.7,
                                         generator=g)

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a.tokens, b.tokens) and torch.equal(a.hidden, b.hidden)
    assert not torch.equal(a.tokens, c.tokens)
    vocab = CFG.llm.vocab_size + 1
    assert ((a.tokens >= 0) & (a.tokens < vocab)).all()
    assert a.lengths.tolist() == [M, M]
    # no generator: seed 0, as the JAX function defaults to PRNGKey(0)
    d = tgen.generate_with_prefix(comp, *tin, max_new_tokens=4, eos_id=NEVER,
                                  temperature=0.7)
    e = tgen.generate_with_prefix(comp, *tin, max_new_tokens=4, eos_id=NEVER,
                                  temperature=0.7)
    assert torch.equal(d.tokens, e.tokens)


@pytest.mark.parametrize("kv_cache", ["bf16", "int8"])
def test_pipeline_options(kv_cache):
    """`build_inference(temperature=, draft_k=, eos_id=None)`: the stop
    tokens come from the LLM type, speculative serving gives the greedy
    tokens, sampled serving repeats under one seed."""
    cfg = port_config(CFG)
    torch.manual_seed(0)
    gi = build_inference(cfg, device="cpu", dtype=torch.float32,
                         kv_cache=kv_cache, max_new_tokens=8)
    assert gi.eos_id == (32000, 32001, 32007) and gi.draft_k == 0
    spec = GroundedInference(gi.model, max_new_tokens=8, draft_k=4)
    samp = GroundedInference(gi.model, max_new_tokens=8, temperature=0.9)
    rng = np.random.RandomState(1)
    raw = torch.from_numpy(rng.randint(0, 256, size=(1, 4, 48, 85, 3),
                                       dtype=np.uint8))
    ids = torch.from_numpy(rng.randint(1, 400, size=(1, 8)))
    ids[0, 2] = IMAGE_TOKEN_INDEX
    lens = torch.tensor([8])
    a = gi.serve_raw(raw, ids, lens, num_sam_frames=1)
    b = spec.serve_raw(raw, ids, lens, num_sam_frames=1)
    assert torch.equal(a.tokens, b.tokens)
    torch.testing.assert_close(a.pred_masks, b.pred_masks, atol=1e-3, rtol=1e-3)
    s1 = samp.serve_raw(raw, ids, lens, num_sam_frames=1,
                        generator=torch.Generator().manual_seed(3))
    s2 = samp.serve_raw(raw, ids, lens, num_sam_frames=1,
                        generator=torch.Generator().manual_seed(3))
    assert torch.equal(s1.tokens, s2.tokens)
    assert torch.isfinite(s1.pred_masks).all()


def test_new_modules_import_and_run_without_jax():
    """The modules of this slice import neither jax nor videoglamm_tpu nor
    anything under scripts/: with those blocked, import them and serve a
    tiny Llama-3.1 model on the CPU, speculative and sampled, and run the
    four fused decode functions and the BSHD attention."""
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'videoglamm_tpu', 'decode_mlp_experiment',\n"
        "             'bench_decode_fused', 'bench_flash_bshd'):\n"
        "    sys.modules[name] = None\n"
        "import dataclasses, torch\n"
        "from videoglamm_torch.experiments import (bench_decode_fused,\n"
        "    decode_mlp, flash_bshd)\n"
        "from videoglamm_torch.models import llama\n"
        "from videoglamm_torch.ops import rope\n"
        "from videoglamm_torch.inference import generate\n"
        "from videoglamm_torch.inference.pipeline import build_inference\n"
        "from videoglamm_torch.config import LlamaConfig, VideoGLaMMConfig\n"
        "cfg = dataclasses.replace(VideoGLaMMConfig.tiny(num_frames=4),\n"
        "    llm_type='llama3_1', llama=LlamaConfig.tiny())\n"
        "raw = torch.randint(0, 256, (1, 4, 48, 85, 3), dtype=torch.uint8)\n"
        "ids = torch.randint(1, 400, (1, 8)); ids[0, 2] = -200\n"
        "for kw in (dict(draft_k=4), dict(temperature=0.7)):\n"
        "    gi = build_inference(cfg, device='cpu', dtype=torch.float32,\n"
        "                         kv_cache='int8', max_new_tokens=4, **kw)\n"
        "    assert gi.eos_id == (128001, 128009)\n"
        "    out = gi.serve_raw(raw, ids, torch.tensor([8]), num_sam_frames=1)\n"
        "    assert out.pred_masks.shape == (1, 4, 1, 32, 32)\n"
        "bench_decode_fused.run_harness(rows=(2,), layers=1, k=32, i=64,\n"
        "    n_qkv=48, device='cpu', dtype=torch.float32, reps=1,\n"
        "    log=lambda s: None)\n"
        "flash_bshd.run_harness(1, 1, 8, 8, 16, 1, 1, device='cpu',\n"
        "    dtype=torch.float32, log=lambda s: None)\n"
        "assert not any(k.split('.')[0] in ('jax', 'flax', 'videoglamm_tpu')\n"
        "               and v is not None\n"
        "               for k, v in sys.modules.items())\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=root, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("ok")

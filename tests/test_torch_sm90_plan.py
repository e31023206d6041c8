"""The geometry of K1's wgmma route and of K6, on the CPU: the route rule,
the window fold that the Hiera block chain and K1's 128-row query tiles
share, and the TMA plans (`k1_tma_plan`, `k6_tma_plan`) that the wrappers
compute before every launch, checked on meta-device views of every
main-path call at its flagship shape (no memory, no card). The kernels
themselves run only on the card (tests/test_torch_cuda.py)."""
import pytest
import torch

from videoglamm_torch.ops import attention as tattn
from videoglamm_torch.ops import fused_block as tfb

BF = torch.bfloat16


def _meta(*shape):
    return torch.empty(*shape, dtype=BF, device="meta")


def test_k1_route_by_dtype_and_head_dim():
    assert tattn.k1_route(BF, 64) == "wgmma"
    assert tattn.k1_route(BF, 128) == "wgmma"
    assert tattn.k1_route(BF, 256) == "mma_sync"
    assert tattn.k1_route(torch.float32, 64) == "mma_sync"
    assert tattn.k1_route(torch.float32, 256) == "mma_sync"


@pytest.mark.parametrize("NW,S,fold", [
    (8192, 16, 8), (8192, 64, 2), (128, 256, 1), (2048, 64, 2),
    (1021, 64, 1), (12, 16, 1), (16, 16, 8)])
def test_window_fold(NW, S, fold):
    """Windows shorter than the 128-row query tile are packed into it (the
    block-diagonal `win` mask) when the fold divides the window count."""
    f = tfb.window_fold(NW, S)
    assert f == fold
    assert S * f <= tattn.K1_BM or f == 1
    assert NW % f == 0


def _bshd_views(x5):
    """q, k, v [B,H,S,D] views of a fused [B,S,3,H,D] projection."""
    return [x5[:, :, i].transpose(1, 2) for i in range(3)]


def _case(name):
    """(q, k, v, out) meta views of a main-path K1 call at flagship size."""
    if name == "phi3_prefill":
        q, k, v, o = (_meta(1, 32, 3391, 96) for _ in range(4))
    elif name == "llama31_prefill":
        q, k, v, o = (_meta(1, 32, 3391, 128) for _ in range(4))
    elif name == "train_causal":
        q, k, v, o = (_meta(2, 32, 3456, 96) for _ in range(4))
    elif name == "clip_bshd":
        q, k, v, o = (_meta(16, 577, 16, 64).transpose(1, 2) for _ in range(4))
    elif name == "iv2_fused_qkv":
        q, k, v = _bshd_views(_meta(4, 1025, 3 * 16 * 88).view(4, 1025, 3, 16, 88))
        o = _meta(4, 1025, 16, 88).transpose(1, 2)
    elif name == "hiera_global":
        qkv = _meta(8 * 4096, 3 * 576)
        q, k, v = (qkv[:, i * 576:(i + 1) * 576].reshape(8, 4096, 8, 72)
                   .transpose(1, 2) for i in range(3))
        o = _meta(8, 4096, 8, 72).transpose(1, 2)
    elif name.startswith("hiera_window"):
        stage = int(name[-1])
        S, C, H = {1: (64, 144, 2), 2: (16, 288, 4), 3: (256, 576, 8),
                   4: (64, 1152, 16)}[stage]
        # 8 frames of 256 x 256 tokens at stage 1, a quarter a stage after
        NW = 8 * 65536 // 4 ** (stage - 1) // S
        f = tfb.window_fold(NW, S)
        qkv5 = _meta(NW * S, 3 * C).view(NW // f, S * f, 3, H, C // H)
        q, k, v = _bshd_views(qkv5)
        o = _meta(NW * S, C).view(NW // f, S * f, H, C // H).transpose(1, 2)
    elif name == "flash_bshd":
        q, o = (_meta(1, 3456, 32, 96).transpose(1, 2) for _ in range(2))
        k, v = (_meta(1, 3520, 32, 96).transpose(1, 2) for _ in range(2))
    return q, k, v, o


MAIN_PATH = ["phi3_prefill", "llama31_prefill", "train_causal", "clip_bshd",
             "iv2_fused_qkv", "hiera_global", "hiera_window1", "hiera_window2",
             "hiera_window3", "hiera_window4", "flash_bshd"]


@pytest.mark.parametrize("name", MAIN_PATH)
def test_k1_tma_plan_accepts_main_path_views(name):
    q, k, v, o = _case(name)
    B, H, Sq, D = q.shape
    assert tattn.k1_route(q.dtype, D) == "wgmma"
    plan = tattn.k1_tma_plan(q, k, v, o)
    assert plan["depth"] % 16 == 0 and D <= plan["depth"] < D + 32
    assert plan["depth"] in tattn.K1_DEPTHS
    assert plan["chunks"] == -(-plan["depth"] // 64)
    for op, t in zip(("q", "k", "v", "out"), (q, k, v, o)):
        m = plan["maps"][op]
        assert m["dims"] == (D, t.shape[2], H, B)
        # byte strides of token, head, batch: the view's own, in place
        for nb, s, n in zip(m["strides"], (t.stride(2), t.stride(1), t.stride(0)),
                            (t.shape[2], H, B)):
            assert nb % 16 == 0 and nb == (2 * s if n > 1 else 16)
        rows = 64 if op == "out" else (tattn.K1_BM if op == "q" else tattn.K1_BN)
        assert m["box"] == (64, rows, 1, 1)


@pytest.mark.parametrize("D,depth", [(16, 32), (32, 32), (64, 64), (72, 80),
                                     (88, 96), (96, 96), (104, 128),
                                     (128, 128)])
def test_k1_tma_plan_pads_depth(D, depth):
    q = _meta(1, 2, 130, D)
    plan = tattn.k1_tma_plan(q, q, q, q)
    assert plan["depth"] == depth
    assert plan["chunks"] == (1 if depth <= 64 else 2)


def test_k1_tma_plan_refuses_misaligned_views():
    # a token stride of 388 elements: 8 bytes off the 16-byte grid
    x = _meta(2, 300, 388)
    q = x[:, :, :128].unflatten(-1, (2, 64)).transpose(1, 2)
    assert q.stride(2) == 388
    ok = _meta(2, 2, 300, 64)
    with pytest.raises(ValueError, match="token stride"):
        tattn.k1_tma_plan(q, ok, ok, ok)
    # a base address 8 bytes past the 16-byte grid
    y = _meta(2, 300, 2 * 64 + 4)[:, :, 4:].unflatten(-1, (2, 64)).transpose(1, 2)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tattn.k1_tma_plan(ok, y, ok, ok)
    # a head dim that is not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        tattn.k1_tma_plan(ok, ok, _meta(2, 2, 64, 300).transpose(2, 3), ok)
    # a broadcast head (stride 0) and a head dim above the route's 128
    z = _meta(2, 1, 300, 64).expand(2, 2, 300, 64)
    with pytest.raises(ValueError, match="head stride"):
        tattn.k1_tma_plan(ok, ok, ok, z)
    big = _meta(1, 1, 64, 256)
    with pytest.raises(ValueError, match="head dim"):
        tattn.k1_tma_plan(big, big, big, big)


# ---------------------------------------------------------------------------
# K6 (flash-attention backward)
# ---------------------------------------------------------------------------
def _k6_case(name):
    """(q, k, v, out, dout) meta views of a K6 launch at the training shape:
    Phi-3 flagship, 2 rows of 3456 positions, 32 heads of 96."""
    B, S, H, hd = 2, 3456, 32, 96
    qkv = _meta(B, S, 3 * H * hd)
    q_, k_, v_ = (x.view(B, S, H, hd).transpose(1, 2)
                  for x in qkv.split([H * hd] * 3, dim=-1))
    if name == "qkv_split":        # no LoRA: q, k, v views of the fused qkv
        q, k, v = q_, k_, v_
    else:                          # RoPE'd q, k and LoRA'd v: new BSHD tensors
        q, k, v = (_meta(B, S, H, hd).transpose(1, 2) for _ in range(3))
    out = _meta(B, H, S, hd)
    # the gradient of o.transpose(1, 2).reshape(B, S, H * hd), handed back
    dout = _meta(B, S, H * hd).view(B, S, H, hd).transpose(1, 2)
    return q, k, v, out, dout


@pytest.mark.parametrize("name", ["qkv_split", "rope_lora"])
def test_k6_tma_plan_accepts_training_views(name):
    q, k, v, out, dout = _k6_case(name)
    B, H, S, D = q.shape
    plan = tattn.k6_tma_plan(q, k, v, out, dout)
    assert plan["depth"] == 96 and plan["chunks"] == 2
    assert set(plan["maps"]) == {"q", "k", "v", "out", "dout", "dq", "dk", "dv"}
    for op, t in (("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout)):
        m = plan["maps"][op]
        assert m["dims"] == (D, S, H, B)
        # read in place: the view's own byte strides of token, head, batch
        assert m["strides"] == (2 * t.stride(2), 2 * t.stride(1), 2 * t.stride(0))
        assert m["box"] == (64, tattn.K6_TILE, 1, 1)
    for op in ("dq", "dk", "dv"):      # new contiguous [B,H,S,D] outputs
        assert plan["maps"][op]["strides"] == (2 * D, 2 * S * D, 2 * H * S * D)
    if name == "qkv_split":
        assert plan["maps"]["v"]["strides"][0] == 2 * 3 * H * D
    assert plan["maps"]["dout"]["strides"][:2] == (2 * H * D, 2 * D)


@pytest.mark.parametrize("D,depth", [(16, 32), (64, 64), (72, 80), (88, 96),
                                     (96, 96), (128, 128)])
def test_k6_tma_plan_pads_depth_and_takes_sq_ne_sk(D, depth):
    q, dout = _meta(2, 3, 200, D), _meta(2, 200, 3, D).transpose(1, 2)
    k = _meta(2, 3, 333, D)
    plan = tattn.k6_tma_plan(q, k, k, q, dout)
    assert plan["depth"] == depth and depth in tattn.K1_DEPTHS
    assert plan["maps"]["k"]["dims"][1] == plan["maps"]["dk"]["dims"][1] == 333
    assert plan["maps"]["q"]["dims"][1] == plan["maps"]["dq"]["dims"][1] == 200


def test_k6_tma_plan_refuses_misaligned_views():
    ok = _meta(2, 2, 300, 64)
    # a dout whose token stride is 388 elements: 8 bytes off the 16-byte grid
    bad = _meta(2, 300, 388)[:, :, :128].unflatten(-1, (2, 64)).transpose(1, 2)
    with pytest.raises(ValueError, match="k6_tma_plan: dout token stride"):
        tattn.k6_tma_plan(ok, ok, ok, ok, bad)
    # an out whose base address is 8 bytes past the 16-byte grid
    off = _meta(2, 300, 2 * 64 + 4)[:, :, 4:].unflatten(-1, (2, 64)).transpose(1, 2)
    with pytest.raises(ValueError, match="out is not 16-byte aligned"):
        tattn.k6_tma_plan(ok, ok, ok, off, ok)
    # a broadcast gradient over heads (stride 0), a head dim not contiguous
    with pytest.raises(ValueError, match="dout head stride"):
        tattn.k6_tma_plan(ok, ok, ok, ok, _meta(2, 1, 300, 64).expand(2, 2, 300, 64))
    with pytest.raises(ValueError, match="k head dim is not contiguous"):
        tattn.k6_tma_plan(ok, _meta(2, 2, 64, 300).transpose(2, 3), ok, ok, ok)
    big = _meta(1, 1, 64, 256)
    with pytest.raises(ValueError, match="head dim 256 above 128"):
        tattn.k6_tma_plan(big, big, big, big, big)


def test_k6_wrapper_copies_only_what_tma_cannot_take():
    """`flash_bwd_kernel` hands TMA every operand as it is unless
    `_tma_refusal` names a reason; a broadcast gradient is made contiguous
    (and the kernel still runs), the BSHD gradient is not."""
    ok = _meta(2, 2, 300, 64)
    assert tattn._tma_refusal(ok) is None
    assert tattn._tma_refusal(_k6_case("qkv_split")[4]) is None
    assert "head stride" in tattn._tma_refusal(
        _meta(2, 1, 300, 64).expand(2, 2, 300, 64))
    assert "contiguous" in tattn._tma_refusal(
        _meta(1, 1, 1, 1).expand(2, 2, 300, 64))

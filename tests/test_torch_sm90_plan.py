"""The geometry of K1, K7 and K6 on Hopper, on the CPU: K1's route rule,
the window fold that the Hiera block chain and K1's 128-row query tiles
share, and the TMA plans (`k1_tma_plan`, `k7_plan`, `k6_tma_plan`) that
the wrappers compute before every launch, checked on meta-device views of
every main-path call at its flagship shape (no memory, no card): depth 256
with its 64-key tiles, the staging copies of the f32 routes, and K7's
query tile on small grids. The kernels themselves run only on the card
(tests/test_torch_cuda.py)."""
import pytest
import torch

from videoglamm_torch.ops import attention as tattn
from videoglamm_torch.ops import fused_block as tfb
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

BF = torch.bfloat16


def _meta(*shape):
    return torch.empty(*shape, dtype=BF, device="meta")


def test_k1_route_by_dtype_and_head_dim():
    """One body for every head dim up to 256; f32 storage goes in through
    the staging pass ("wgmma_f32")."""
    assert tattn.k1_route(BF, 64) == "wgmma"
    assert tattn.k1_route(BF, 128) == "wgmma"
    assert tattn.k1_route(BF, 256) == "wgmma"
    assert tattn.k1_route(torch.float32, 64) == "wgmma_f32"
    assert tattn.k1_route(torch.float32, 256) == "wgmma_f32"


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
                                     (128, 128), (136, 256), (200, 256),
                                     (256, 256)])
def test_k1_tma_plan_pads_depth(D, depth):
    q = _meta(1, 2, 130, D)
    plan = tattn.k1_tma_plan(q, q, q, q)
    assert plan["depth"] == depth
    assert plan["chunks"] == {32: 1, 64: 1, 256: 4}.get(depth, 2)
    # 64-key tiles at depth 256: Q, two stages of K and V in 227 KB
    bn = 64 if depth == 256 else 128
    assert plan["key_tile"] == tattn.key_tile(depth) == bn
    assert plan["maps"]["k"]["box"] == plan["maps"]["v"]["box"] == (64, bn, 1, 1)
    smem = 128 * depth * 2 + 2 * 2 * bn * 64 * 2 * plan["chunks"]
    assert smem <= 227 * 1024


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
    # a broadcast head (stride 0) and a head dim above the body's 256
    z = _meta(2, 1, 300, 64).expand(2, 2, 300, 64)
    with pytest.raises(ValueError, match="head stride"):
        tattn.k1_tma_plan(ok, ok, ok, z)
    big = _meta(1, 1, 64, 264)
    with pytest.raises(ValueError, match="head dim 264 above 256"):
        tattn.k1_tma_plan(big, big, big, big)


def _f32(*shape):
    return torch.empty(*shape, dtype=torch.float32, device="meta")


@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_k1_tma_plan_at_depth_256_and_staging(dtype):
    """The tracker's memory self-attention [4,1,4096,256] (f32 on the main
    path, bf16 too): depth 256 in four chunks, 64-key tiles. f32 operands
    are read through the staging pass's contiguous bf16 copies, whose
    shapes the plan lists, and their f32 output has no map (direct
    stores); bf16 operands are read in place and stored through a map."""
    q, k, v, o = (torch.empty(4, 1, 4096, 256, dtype=dtype, device="meta")
                  for _ in range(4))
    plan = tattn.k1_tma_plan(q, k, v, o)
    assert (plan["depth"], plan["chunks"], plan["key_tile"]) == (256, 4, 64)
    assert plan["maps"]["q"]["box"] == (64, tattn.K1_BM, 1, 1)
    for op in ("q", "k", "v"):
        m = plan["maps"][op]
        assert m["dims"] == (256, 4096, 1, 4)
        assert m["strides"] == (512, 16, 512 * 4096)   # contiguous bf16
    if dtype == torch.float32:
        assert plan["staged"] == {n: (4, 1, 4096, 256) for n in ("q", "k", "v")}
        assert "out" not in plan["maps"]
    else:
        assert plan["staged"] is None
        assert plan["maps"]["out"]["box"] == (64, 64, 1, 1)


def test_staging_copies_make_broadcast_f32_views_tma_ready():
    """The staging pass writes new contiguous bf16 tensors, so an f32 view
    that TMA could not take in place (keys broadcast over heads: a head
    stride of 0) is still planned, where the same view in bf16 is refused;
    Sq != Sk keeps each operand's rows."""
    q = _f32(2, 300, 4, 256).transpose(1, 2)                  # BSHD view
    k = _f32(2, 1, 500, 256).expand(2, 4, 500, 256)
    plan = tattn.k1_tma_plan(q, k, k, _f32(2, 4, 300, 256))
    assert plan["staged"]["q"] == (2, 4, 300, 256)
    assert plan["staged"]["k"] == (2, 4, 500, 256)
    assert plan["maps"]["q"]["strides"] == (512, 512 * 300, 512 * 300 * 4)
    assert plan["maps"]["k"]["dims"] == (256, 500, 4, 2)
    kb = _meta(2, 1, 500, 256).expand(2, 4, 500, 256)
    with pytest.raises(ValueError, match="k head stride"):
        tattn.k1_tma_plan(_meta(2, 4, 300, 256), kb, kb, _meta(2, 4, 300, 256))


@pytest.mark.parametrize("B,H,S,D,dtype,rows,ctas,depth", [
    (4, 1, 1024, 256, torch.float32, 64, 64, 256),    # memory, 32x32 grid
    (4, 16, 1025, 88, BF, 128, 9 * 64, 96),           # InternVideo2 shape
    (16, 16, 577, 64, BF, 128, 5 * 256, 64),          # CLIP shape
    (3, 1, 520, 256, BF, 64, 9 * 3, 256),
    (1, 2, 1536, 96, BF, 64, 24 * 2, 96),
])
def test_k7_plan_picks_the_query_tile(B, H, S, D, dtype, rows, ctas, depth):
    """128-query tiles (two consumer warpgroups) unless they would leave
    more than half of the H100's 132 SMs idle; then 64-query tiles."""
    q = torch.empty(B, H, S, D, dtype=dtype, device="meta")
    plan = tattn.k7_plan(q, q, q, q, 132)
    assert plan["query_rows"] == rows and plan["ctas"] == ctas
    assert plan["depth"] == depth and plan["key_tile"] == tattn.key_tile(depth)
    assert plan["maps"]["q"]["box"] == (64, rows, 1, 1)
    wide = -(-S // 128) * B * H
    assert (rows == 64) == (2 * wide < 132)


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
    assert plan["depth"] == depth and depth in tattn.K6_DEPTHS
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

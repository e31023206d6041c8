"""Operations and bytes, counted from a configuration's sizes and a cell's
shapes, never from the program's code.

The `mfu` convention: a matrix product of [M, K] by [K, N] counts 2MNK; an
attention of Sq queries over Sk keys at width D counts 4 Sq Sk D (QK^T and
PV), and a causal one half of that square; the towers, the LLM and SAM-2
count their forward in full; training adds the LLM's activation gradients
(its forward again) and the weight gradients of the trainable leaves only,
with the frozen base's none; recomputation under remat is not counted.
Norms, softmax, elementwise work and pooling count nothing.

Bytes of a kernel: each input read once and each output written once, at
its stored width."""
from __future__ import annotations

PEAK_BF16 = 989e12      # NVIDIA H100 SXM, dense bf16 tensor cores, FLOP/s
HBM = 3.35e12           # NVIDIA H100 SXM, device memory, bytes/s


def least_s(flops: float, nbytes: float, peak: float = PEAK_BF16) -> float:
    """The least time the card can take: the larger of its two bounds."""
    return max(flops / peak, nbytes / HBM)


def mm(m, k, n) -> float:
    return 2.0 * m * k * n


def attn(sq, sk, d, causal=False) -> float:
    return 4.0 * sq * sk * d * (0.5 if causal else 1.0)


# ---------------------------------------------------------------- towers
def internvideo2(c: dict, clips: int, num_frames: int) -> float:
    """InternVideo2 over `clips` chunks of `num_frames` frames (cls token +
    patches), the blocks that run (depth - 1: the tower returns the
    second-to-last block's tokens)."""
    iv = c["internvideo"]
    D, p, g = iv["embed_dim"], iv["patch_size"], iv["image_size"] // iv["patch_size"]
    n = num_frames * g * g + 1
    ff = int(D * iv["mlp_ratio"])
    per_block = mm(n, D, 3 * D) + mm(n, D, D) + 2 * mm(n, D, ff) + attn(n, n, D)
    patch = mm(num_frames * g * g, 3 * p * p, D)
    return clips * (patch + (iv["depth"] - 1) * per_block)


def clip(c: dict, images: int) -> float:
    """CLIP ViT over `images` images: the layers up to select_layer."""
    cl = c["clip"]
    D, p, g = cl["hidden_size"], cl["patch_size"], cl["image_size"] // cl["patch_size"]
    n = g * g + 1
    sel = cl["select_layer"]
    layers = cl["num_layers"] + sel + 1 if sel < 0 else sel
    per = 4 * mm(n, D, D) + 2 * mm(n, D, cl["intermediate_size"]) + attn(n, n, D)
    return images * (mm(g * g, 3 * p * p, D) + layers * per)


def projectors(c: dict, frames: int) -> float:
    """The two mlp2x projectors over every frame's tokens (before pooling)."""
    H = c["llm"]["hidden_size"]
    iv, cl = c["internvideo"], c["clip"]
    lv = (iv["image_size"] // iv["patch_size"]) ** 2
    lc = (cl["image_size"] // cl["patch_size"]) ** 2
    return frames * (mm(lv, iv["embed_dim"], H) + mm(lv, H, H)
                     + mm(lc, cl["hidden_size"], H) + mm(lc, H, H))


def visual_tokens(c: dict) -> int:
    """Visual prefix length: pooled context then video tokens, every frame."""
    vp, cp = c["video_pool"], c["context_pool"]
    return c["num_frames"] * (vp[0] * vp[1] + cp[0] * cp[1])


def towers(c: dict, videos: int) -> float:
    T = c["num_frames"]
    ck = c["chunk_size"]
    return (internvideo2(c, videos * T // ck, ck) + clip(c, videos * T)
            + projectors(c, videos * T))


# ---------------------------------------------------------------- LLM
def llm_layer_weights(c: dict) -> dict:
    """(N, K) of the four projections of one decoder layer."""
    l = c["llm"]
    D, hd = l["hidden_size"], l["head_dim"]
    q, kv = l["num_heads"] * hd, l["num_kv_heads"] * hd
    return {"qkv": (q + 2 * kv, D), "o": (D, q),
            "gate_up": (2 * l["intermediate_size"], D),
            "down": (D, l["intermediate_size"])}


def vocab(c: dict) -> int:
    return c["llm"]["vocab_size"] + 1          # + [SEG]


def llm_tokens(c: dict, tokens: int) -> float:
    """The products of every layer over `tokens` rows (no attention, no head)."""
    w = llm_layer_weights(c)
    return c["llm"]["num_layers"] * sum(mm(tokens, k, n) for n, k in w.values())


def llm_attention(c: dict, sq: int, sk: int, causal: bool) -> float:
    l = c["llm"]
    return l["num_layers"] * attn(sq, sk, l["num_heads"] * l["head_dim"], causal)


def lm_head(c: dict, rows: int) -> float:
    return mm(rows, c["llm"]["hidden_size"], vocab(c))


def llm_prefill(c: dict, length: int) -> float:
    return llm_tokens(c, length) + llm_attention(c, length, length, True)


def llm_decode_step(c: dict, kv_len: int) -> float:
    """One row of one decode step over a cache of kv_len positions
    (the fed token's own included)."""
    return llm_tokens(c, 1) + llm_attention(c, 1, kv_len, False) + lm_head(c, 1)


# ---------------------------------------------------------------- SAM-2
def hiera(c: dict, images: int) -> float:
    """Hiera over `images` images at the configured size, walking the blocks
    as the trunk builds them: windowed blocks attend inside their window,
    global blocks over the whole grid, a pooling block's queries pooled 2x2
    over the previous stage's windows."""
    h = c["sam2"]["hiera"]
    stride = h["patch_stride"]
    grid = c["sam2"]["image_size"] // stride
    dim, stages = h["embed_dim"], h["stages"]
    total = mm(grid * grid, 3 * h["patch_kernel"] ** 2, dim)
    stage_ends = [sum(stages[:i]) - 1 for i in range(1, len(stages) + 1)]
    q_pool_blocks = [e + 1 for e in stage_ends[:-1]][:h["q_pool"]]
    cur = 1
    for i in range(sum(stages)):
        dim_out = dim
        ws = h["window_spec"][cur - 1]
        if i in h["global_att_blocks"]:
            ws = 0
        if i - 1 in stage_ends:
            dim_out = int(dim * h["dim_mul"])
            cur += 1
        n_in = grid * grid
        pool = i in q_pool_blocks
        n_out = n_in // 4 if pool else n_in
        f = mm(n_in, dim, 3 * dim_out) + mm(n_out, dim_out, dim_out)
        if dim != dim_out:
            f += mm(n_in, dim, dim_out)
        f += 2 * mm(n_out, dim_out, int(dim_out * h["mlp_ratio"]))
        if ws == 0:
            f += attn(n_out, n_in, dim_out)
        else:
            keys = ws * ws
            f += n_out * 4.0 * keys * dim_out
        total += f
        if pool:
            grid //= 2
        dim = dim_out
    return images * total


def fpn(c: dict, images: int) -> float:
    """FPN laterals (1x1 to d_model), the two skip projections conv_s0/s1."""
    s = c["sam2"]
    d = s["d_model"]
    h = s["hiera"]
    grid = s["image_size"] // h["patch_stride"]
    dims = [int(h["embed_dim"] * h["dim_mul"] ** i) for i in range(len(h["stages"]))]
    grids = [grid >> i for i in range(len(dims))]
    keep = len(dims) - s["backbone_scalp"]
    f = sum(mm(grids[i] ** 2, dims[i], d) for i in range(keep))
    f += mm(grids[0] ** 2, d, d // 8) + mm(grids[1] ** 2, d, d // 4)
    return images * f


def mask_decoder(c: dict, prompts: int) -> float:
    """The two-way transformer (depth 2, attention downsampled 2x in its
    cross-attentions), the final token-to-image attention, the upscaling
    transposed convolutions and the hypernetwork MLPs, for one sparse
    prompt and the decoder's output tokens."""
    s = c["sam2"]
    d = s["d_model"]
    E = s["image_size"] // 16
    n_img = E * E
    t = 1 + 4 + 1 + 1                  # iou, 4 mask, object-score, 1 prompt
    di = d // 2
    cross = (mm(t, d, di) + 2 * mm(n_img, d, di) + attn(t, n_img, di)
             + mm(t, di, d))
    layer = (4 * mm(t, d, d) + attn(t, t, d) + 2 * cross
             + 2 * mm(t, d, 2048))
    f = 2 * layer + cross
    f += mm(n_img * 4, d, d // 4) + mm(n_img * 16, d // 4, d // 8)
    f += 4 * (2 * mm(1, d, d) + mm(1, d, d // 8)) + mm(n_img * 16, d // 8, 4)
    return prompts * f


def sam_encode(c: dict, images: int) -> float:
    return hiera(c, images) + fpn(c, images)


# ---------------------------------------------------------------- requests
def gcg_request(c: dict, prompt_tokens: int, new_tokens: int,
                sam_frames: int) -> float:
    """One grounded-captioning request: towers over the clip, the prefill
    over the spliced prompt, the decode steps, the [SEG] head and the SAM-2
    encode and mask decode over every [SEG] slot and SAM frame."""
    P = prompt_tokens - 1 + visual_tokens(c)
    f = towers(c, 1) + llm_prefill(c, P) + lm_head(c, 1)
    f += sum(llm_decode_step(c, P + i + 1) for i in range(new_tokens))
    H, o = c["llm"]["hidden_size"], c["out_dim"]
    f += c["max_seg_tokens"] * (mm(1, H, H) + mm(1, H, o))
    f += sam_encode(c, sam_frames) + mask_decoder(c, c["max_seg_tokens"] * sam_frames)
    return f


# ---------------------------------------------------------------- kernels
def k5_call(M: int, N: int, K: int, weight_bits: int = 8) -> tuple:
    """(flops, bytes) of one dequantising product of M rows: int8 weights
    [N, K] and f32 scales [N] read once, bf16 x read, bf16 y written."""
    w = N * K * weight_bits // 8
    scales = 4 * N * (1 if weight_bits == 8 else K // 128)
    return mm(M, K, N), w + scales + 2 * M * K + 2 * M * N


def k4_call(c: dict, kv_lens) -> tuple:
    """(flops, bytes) of one decode attention over the int8 cache: each row
    reads K and V codes and their per-token, per-head f32 scales up to its
    kv_len, its bf16 query, and writes its bf16 output."""
    l = c["llm"]
    H, Hkv, hd = l["num_heads"], l["num_kv_heads"], l["head_dim"]
    flops = sum(4.0 * H * hd * n for n in kv_lens)
    nbytes = sum(n * Hkv * (2 * hd + 2 * 4) for n in kv_lens)
    nbytes += len(kv_lens) * H * hd * 2 * 2
    return flops, nbytes


def causal_pairs(sq: int, kv_len: int) -> int:
    """(query, key) pairs a causal row block of sq queries from position 0
    attends when keys stop at kv_len."""
    full = min(sq, kv_len)
    return full * (full + 1) // 2 + (sq - full) * kv_len


def k6_call(c: dict, seq: int, kv_lens) -> tuple:
    """(flops, bytes) of one attention backward (the delta pass, dq and
    dk/dv) over a causal [rows, H, seq, hd] layer: five products per
    attended pair (S recomputed from the saved log-sum-exp, dP, dV, dQ,
    dK); q, k, v, o, dO read and dq, dk, dv written in bf16, the f32
    log-sum-exp read and delta written."""
    l = c["llm"]
    H, hd = l["num_heads"], l["head_dim"]
    rows = len(kv_lens)
    pairs = sum(causal_pairs(seq, n) for n in kv_lens)
    flops = 5 * 2.0 * pairs * hd * H
    nbytes = rows * H * seq * (8 * hd * 2 + 2 * 4)
    return flops, nbytes


def train_step(c: dict, videos: int, rows: int, seq: int, sam_frames: int,
               accum: int) -> float:
    """Model FLOPs of one optimizer step: per micro-step the frozen towers
    and SAM-2 encoder forward, the LLM forward over rows x seq positions
    and its activation gradients (the products again, attention twice),
    the lm_head forward, activation and weight gradients (it trains), and
    the mask decoder forward and backward (it trains) over every [SEG] slot
    and SAM frame. LoRA, the [SEG] head and remat are not counted."""
    H = c["llm"]["hidden_size"]
    f = towers(c, videos) + sam_encode(c, videos * sam_frames)
    f += rows * (2 * llm_tokens(c, seq) + 3 * llm_attention(c, seq, seq, True))
    f += 3 * lm_head(c, rows * seq)
    f += 3 * mask_decoder(c, rows * c["max_seg_tokens"] * sam_frames)
    return accum * f

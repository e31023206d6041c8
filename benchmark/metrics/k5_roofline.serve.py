"""K5, the int8 decode GEMV (csrc/dequant_gemv.cu): the least time that the
traced batch's K5 products can take on the card, as a share (%) of the
device time of the kernels named below. The products are counted from the
cell's shapes: every decode step runs the four projections of every layer
and the lm_head over the batch's rows, and the prefill runs the lm_head
over the rows' last prompt positions. At 4 rows and more K5 runs on the
tensor cores, so its compute bound is taken at the bf16 rate."""
import flops as F

KERNELS = r"gemv_(rows|mma|f32_tc)_kernel"


def least_s(c, rows: int, steps: int) -> float:
    shapes = list(F.llm_layer_weights(c).values())
    per_step = c["llm"]["num_layers"] * sum(
        F.least_s(*F.k5_call(rows, n, k)) for n, k in shapes)
    head = F.least_s(*F.k5_call(rows, F.vocab(c), c["llm"]["hidden_size"]))
    return steps * (per_step + head) + head


def read(layer):
    t = layer["trace"].kernel_s(KERNELS)
    if t is None:
        return None
    rows = len(layer["traced_lengths"])
    return 100.0 * least_s(layer["config"], rows,
                           layer["traffic"]["new_tokens"]) / t

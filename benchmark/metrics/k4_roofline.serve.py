"""K4, the decode attention over the int8 KV cache
(csrc/decode_attention_q8.cu): the least time of the traced batch's K4
calls as a share (%) of their device time. One call a layer and decode
step; row b reads its cache up to its spliced prompt length plus the
tokens fed so far, the one just written included."""
import flops as F

KERNELS = r"decode_q8_kernel"


def read(layer):
    t = layer["trace"].kernel_s(KERNELS)
    if t is None:
        return None
    c = layer["config"]
    V = F.visual_tokens(c)
    prompts = [n - 1 + V for n in layer["traced_lengths"]]
    least = 0.0
    for i in range(layer["traffic"]["new_tokens"]):
        least += c["llm"]["num_layers"] * F.least_s(
            *F.k4_call(c, [p + i + 1 for p in prompts]))
    return 100.0 * least / t

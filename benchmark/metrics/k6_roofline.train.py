"""K6, the attention backward (csrc/flash_bwd.cu: the delta pass, dq and
dk/dv): the least time of the traced step's K6 calls as a share (%) of
their device time. One call a layer and micro-step, over the rows' causal
[H, seq, hd] with each row's keys ending at its spliced length."""
import flops as F

KERNELS = r"flash_bwd_(delta|dq|dkv)"


def read(layer):
    t = layer["trace"].kernel_s(KERNELS)
    if t is None:
        return None
    c, tr = layer["config"], layer["traffic"]
    V = F.visual_tokens(c)
    seq = tr["text_tokens"] - 1 + V
    kv = [n - 1 + V for n in tr["text_lens"][:tr["rows"]]]
    calls = c["llm"]["num_layers"] * c["mode"]["train"]["grad_accum_steps"]
    return 100.0 * calls * F.least_s(*F.k6_call(c, seq, kv)) / t

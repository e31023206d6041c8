"""The allocator's peak over the window (torch.cuda.max_memory_allocated
after a reset at the window's start), GiB."""


def read(layer):
    return layer["peak_bytes"] / 2**30 if layer["peak_bytes"] else None

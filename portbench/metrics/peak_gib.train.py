"""peak_gib.train: the allocator's peak over the window
(``torch.cuda.max_memory_allocated`` after a reset at its start), in GiB."""


def read(ctx):
    if ctx.get("driver") != "train" or not ctx["window_peak_bytes"]:
        return None
    return ctx["window_peak_bytes"] / 2**30

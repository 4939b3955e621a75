"""The allocator's peak over the window (reset at the window's start),
torch.cuda.max_memory_allocated, in GiB."""


def read(run):
    if run.device.type != "cuda":
        return None
    return run.peak_bytes / 1024 ** 3

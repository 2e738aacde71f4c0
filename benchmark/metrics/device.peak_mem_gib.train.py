"""torch.cuda.max_memory_allocated over the window, GiB (layer: device)."""
from benchmark import readers


def read(ctx):
    return readers.peak_mem_gib(ctx)

"""Whether a committee's proof fits one card: the allocator's peak over the
window (``torch.cuda.max_memory_allocated`` after a reset at its start),
in GiB."""


def read(run):
    return run.peak_bytes / (1 << 30) if run.peak_bytes else None

"""The allocator's peak over the window
(``torch.cuda.max_memory_allocated`` after a reset at its start), GiB:
it bounds the rows one card can cluster."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None

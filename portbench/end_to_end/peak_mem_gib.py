"""``peak_mem_gib``: ``torch.cuda.max_memory_allocated()`` over the window
(its count is reset as the window opens), less the bytes the harness
itself holds on the card (its pool of input pairs and the answers it keeps
for the check), in GiB: what the program allocates."""


def read(r):
    if r.program_peak_bytes is None:
        return None
    return r.program_peak_bytes / 2**30

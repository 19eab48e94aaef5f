"""torch.cuda.max_memory_allocated() over set-up and window, in GiB: the
size of case a card can hold."""

UNIT = "GiB"


def read(run):
    if run.peak_bytes is None:
        return None
    return run.peak_bytes / 2 ** 30

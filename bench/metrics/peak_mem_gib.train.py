"""``torch.cuda.max_memory_allocated`` over the window, in GiB (the peak
counter is reset as the window opens)."""


def read(run):
    if not run.memory_peak:
        return None
    return run.memory_peak / 2 ** 30

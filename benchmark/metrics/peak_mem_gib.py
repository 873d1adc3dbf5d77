"""peak_mem_gib: the most device memory the program held while it
served the window's requests: ``torch.cuda.max_memory_allocated()``
read as the window closes, after ``reset_peak_memory_stats()`` at its
start, in GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None

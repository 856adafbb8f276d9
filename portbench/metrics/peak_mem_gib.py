"""The run's ``torch.cuda.max_memory_allocated()`` (reset at its start,
read when the window closes, the captured graph's pool included), GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None

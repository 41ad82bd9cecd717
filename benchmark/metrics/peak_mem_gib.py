"""peak_mem_gib.<cell>: ``torch.cuda.max_memory_allocated()`` over the
traced run's window, reset at its start: the port alone (the reference is
not on the device then)."""


def read(drv, suffix):
    peak = getattr(drv, "window_peak_bytes", None)
    return None if not peak else peak / 2 ** 30

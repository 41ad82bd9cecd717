"""decode_ms.<cell>: median time from the last step's synchronised mark to
the request's return (VAE decode, safety checker, host copy)."""


def read(drv, suffix):
    fn = getattr(drv, "decode_ms", None)
    return fn() if fn else None

"""plain_step_ms: median time of a plain CFG step (one UNet forward at
twice the batch), between synchronised marks."""


def read(drv, suffix):
    fn = getattr(drv, "step_ms", None)
    return fn("plain") if fn else None

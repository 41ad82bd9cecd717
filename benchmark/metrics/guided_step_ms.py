"""guided_step_ms: median time of a guided step (two UNet forwards, the
LGP head and the backward to the latent), between synchronised marks."""


def read(drv, suffix):
    fn = getattr(drv, "step_ms", None)
    return fn("guided") if fn else None

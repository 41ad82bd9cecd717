"""train_step_ms: median of the trainer's own step times
(``TrainResult.step_seconds``: host clock, data wait included, ending in
the loss read) over the window's steps."""

import statistics


def read(drv, suffix):
    secs = getattr(drv, "unit_seconds", None)
    return 1e3 * statistics.median(secs) if secs else None

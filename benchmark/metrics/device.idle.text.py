"""device.idle.text (layer: device): the share of the traced window in
which nothing ran on the card (no kernel, copy or memset), in %."""

LAYER = "device"
MOVES = "feature_stim_s_per_s"


def read(run):
    if run.trace is None or not run.trace.window_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)

"""feature_stim_s_per_s: seconds of stimulus encoded per second of the
window (windows completed x the stimulus seconds a window stands for, over
the window's seconds, the last batch's return to the host included)."""


def read(run):
    stim = run.work.get("stim_s")
    return stim / run.window_s if stim else None

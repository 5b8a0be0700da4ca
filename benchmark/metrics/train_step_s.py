"""train_step_s: the window's seconds over the optimizer steps completed in
it (the window ends with a synchronize, so every step counted is done)."""


def read(run):
    steps = run.work.get("steps")
    return run.window_s / steps if steps else None

"""All tokens of the steps completed in the window, over the window's
wall (host clock, ending in a synchronize)."""


def read(run):
    if run.steps == 0 or run.window_s <= 0:
        return None
    return run.steps * run.tokens_per_step / run.window_s

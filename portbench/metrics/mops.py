"""NPB's Mop/s: the operations the configuration's source counts for the
work completed in the window, over the window's host-clock seconds."""


def read(r):
    if not r.window_s or r.window_ops is None:
        return None
    return r.window_ops / r.window_s / 1e6

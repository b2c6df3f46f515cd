"""Share of the traced window, whole paths only, in which no kernel, copy or
set ran on the card."""


def read(run):
    tr = run["trace"]
    if tr is None or tr.window is None or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s())

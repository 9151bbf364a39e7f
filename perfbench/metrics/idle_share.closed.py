"""idle_share.closed: share of the traced sub-window in which no kernel, copy or
set ran on the device, in % (the closed-loop cells)."""


def read(rec):
    tr = rec["trace"]
    if not tr or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])

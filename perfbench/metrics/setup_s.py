"""setup_s: from process start to the window's start (imports, kernel
build, weights, prune and pack, engine, warm-up, and the set-up the
traffic needs, such as the closed loop's fill)."""


def read(rec):
    return rec["setup_s"]

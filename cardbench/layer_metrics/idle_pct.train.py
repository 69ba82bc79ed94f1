"""idle_pct.train: the share of the traced window in which no kernel, copy or
set ran on the card, 100 (1 - busy / window), busy the union of the
trace's device spans."""


def read(ctx):
    if ctx["traffic"]["kind"] != "train":
        return None
    tr = ctx["trace"]
    return 100.0 * (1.0 - tr.busy_s / tr.wall_s)

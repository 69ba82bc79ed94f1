"""swa_fwd_ms.train: device ms a training step launched inside the
sliding-window attention blocks' forward calls (``SWABlock``, the first
forward and the remat's recomputed one), less their ln1, ln2 and mlp child
calls: the attention itself.  Read from ranges that forward hooks open
around those modules in the traced run."""

LABEL = "swa_block"
CHILDREN = ("ln1", "ln2", "mlp")


def annotate(model, ann):
    for mod in model.modules():
        if type(mod).__name__ == "SWABlock":
            ann.add(mod, LABEL)
            for c in CHILDREN:
                ann.add(getattr(mod, c), f"{LABEL}.{c}")


def read(ctx):
    if ctx["traffic"]["kind"] != "train":
        return None
    tr = ctx["trace"]
    total = tr.seconds_in(LABEL)
    if total <= 0.0:
        return None
    inner = sum(tr.seconds_in(f"{LABEL}.{c}") for c in CHILDREN)
    return (total - inner) * 1e3 / ctx["traced"]["steps"]

"""bwd_ms.train: device ms a training step launched inside the program's
``train.backward`` span (``loss.backward()``) and inside none of its
forward spans (``spectre.block``, ``swa.block``, ``head_ce``): the
backward without the remat's recompute."""

from cardbench import spans


def read(ctx):
    if ctx["traffic"]["kind"] != "train":
        return None
    return spans.device_ms(ctx["trace"], [("train.backward",)],
                           ctx["traced"]["steps"], outside=spans.FORWARD)

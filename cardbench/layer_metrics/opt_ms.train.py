"""opt_ms.train: device ms a training step launched inside the program's
``train.optimizer`` span (the gradient list, the clipping norm and
AdamW's multi-tensor update)."""

from cardbench import spans


def read(ctx):
    if ctx["traffic"]["kind"] != "train":
        return None
    return spans.device_ms(ctx["trace"], [("train.optimizer",)],
                           ctx["traced"]["steps"])

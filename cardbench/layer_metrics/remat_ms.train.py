"""remat_ms.train: device ms a training step launched inside a forward
span (``spectre.block``, ``swa.block``, ``head_ce``) inside the
program's ``train.backward`` span: the operations the remat recomputes."""

from cardbench import spans


def read(ctx):
    if ctx["traffic"]["kind"] != "train":
        return None
    return spans.device_ms(ctx["trace"], [("train.backward",), spans.FORWARD],
                           ctx["traced"]["steps"])

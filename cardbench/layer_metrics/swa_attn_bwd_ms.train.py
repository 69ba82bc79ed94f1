"""swa_attn_bwd_ms.train: device ms a training step launched inside the
program's ``swa.attention.backward`` span (from the backward of the
attention's output to that of its input, ``utils/prof.py::backward_span``)
and inside none of its forward spans: the sliding-window attention's
backward."""

from cardbench import spans


def read(ctx):
    if ctx["traffic"]["kind"] != "train":
        return None
    return spans.device_ms(ctx["trace"], [("swa.attention.backward",)],
                           ctx["traced"]["steps"], outside=spans.FORWARD)

"""swa_attn_fwd_ms.train: device ms a training step launched inside the
program's ``swa.attention`` span (``swa_apply`` in ``SWABlock.forward``,
the first forward and the remat's recompute): the sliding-window
attention's forward, measured inside the program (``swa_fwd_ms.train``
reads it from the harness's forward hooks)."""

from cardbench import spans


def read(ctx):
    if ctx["traffic"]["kind"] != "train":
        return None
    return spans.device_ms(ctx["trace"], [("swa.attention",)],
                           ctx["traced"]["steps"])

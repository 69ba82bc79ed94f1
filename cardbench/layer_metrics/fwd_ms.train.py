"""fwd_ms.train: device ms a training step launched inside the program's
``train.forward`` span (``train/loop.py::_optimizer_step``'s call of the
loss: embeddings, blocks, final LN and the chunked CE's forward)."""

from cardbench import spans


def read(ctx):
    if ctx["traffic"]["kind"] != "train":
        return None
    return spans.device_ms(ctx["trace"], [("train.forward",)],
                           ctx["traced"]["steps"])

"""spectre_gates_ms.train: device ms a training step launched inside the
program's ``spectre.gates`` span (``layers/spectre.py::causal_chunk_gates``:
the chunk-cumulative descriptors and the gate MLP, in the first forward
and in the remat's recompute)."""

from cardbench import spans


def read(ctx):
    if ctx["traffic"]["kind"] != "train":
        return None
    return spans.device_ms(ctx["trace"], [("spectre.gates",)],
                           ctx["traced"]["steps"])

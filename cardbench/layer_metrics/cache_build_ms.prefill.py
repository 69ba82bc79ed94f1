"""cache_build_ms.prefill: device ms a request launched inside the
program's ``prefill.cache`` span (``decode/cache.py::spectre_block_prefill``:
each layer's LN, fp32 per-head projections and the decode cache's
prefix spectrum and ring buffers)."""

from cardbench import spans


def read(ctx):
    if ctx["traffic"]["kind"] != "prefill":
        return None
    return spans.device_ms(ctx["trace"], [("prefill.cache",)],
                           ctx["traced"]["requests"])

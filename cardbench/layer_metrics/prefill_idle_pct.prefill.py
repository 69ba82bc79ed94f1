"""prefill_idle_pct.prefill: the share of the program's ``prefill`` spans'
time (``models/lm.py::lm_prefill``, each to the end of the last device
operation launched in it) in which no kernel, copy or set ran, in %: the
idle time the program makes, without the harness's loop between requests
(which ``idle_pct.prefill`` counts)."""

from cardbench import spans


def read(ctx):
    if ctx["traffic"]["kind"] != "prefill":
        return None
    return spans.idle_pct(ctx["trace"], "prefill")

"""launches_per_request.prefill: the device operations (kernels, copies
and sets) launched inside the program's ``prefill`` spans, per traced
request."""

from cardbench import spans


def read(ctx):
    if ctx["traffic"]["kind"] != "prefill":
        return None
    ops = spans.launched(ctx["trace"], [("prefill",)])
    if ops is None:
        return None
    return len(ops) / ctx["traced"]["requests"]

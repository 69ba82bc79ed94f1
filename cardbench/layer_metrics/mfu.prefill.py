"""mfu.prefill: the model operations of the window's prefills (the forward,
the logits of the last position and the decode caches' build,
``cardbench.workmodels.flops.prefill``) over the window's time and the peak
of the configuration's compute dtype, in %."""

from cardbench.workmodels import flops, peak_flops


def read(ctx):
    t = ctx["traffic"]
    if t["kind"] != "prefill":
        return None
    w = ctx["window"]
    ops = t["batch"] * sum(flops.prefill(ctx["config"], n)
                           for n in w["lengths"])
    return 100.0 * ops / w["seconds"] / peak_flops(ctx["config"])

"""mfu.train: the model operations of the window's training steps
(``cardbench.workmodels.flops.train_step``; the remat's recomputed forward
not counted) over the window's time and the peak of the configuration's
compute dtype, in %."""

from cardbench.workmodels import flops, peak_flops


def read(ctx):
    t = ctx["traffic"]
    if t["kind"] != "train":
        return None
    w = ctx["window"]
    ops = flops.train_step(ctx["config"], t["batch"], t["seq"]) * w["steps"]
    return 100.0 * ops / w["seconds"] / peak_flops(ctx["config"])

"""causal_roofline.train: the bounds of every #9, #7 and #11 call of the
profiled training steps (the recomputed forward's too; frozen work models,
``cardbench.workmodels.causal``) over the device time of their launches,
in %.  The calls are counted by their launches in the trace."""

import collections

from cardbench.workmodels import causal


def read(ctx):
    t = ctx["traffic"]
    if t["kind"] != "train":
        return None
    spans = ctx["trace"].kernels(causal.KERNELS)
    if not spans:
        return None
    count = collections.Counter(name for name, _ in spans)
    calls = causal.layer_calls(ctx["config"], t["batch"], t["seq"])
    bound = sum(count[causal.CALL_KERNEL[k]] * work.bound_s()
                for k, work in calls.items())
    return 100.0 * bound / sum(s for _, s in spans)

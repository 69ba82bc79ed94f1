"""causal_roofline.prefill: the bounds of the #9 and #7 calls of the
profiled prefills (one of each a layer and request, at the request's
length; frozen work models, ``cardbench.workmodels.causal``) over the
device time of their launches, in %.  Silent where the trace does not hold
exactly those calls."""

import collections

from cardbench.reference.model import layers
from cardbench.workmodels import causal


def read(ctx):
    t = ctx["traffic"]
    if t["kind"] != "prefill":
        return None
    spans = ctx["trace"].kernels(causal.KERNELS)
    count = collections.Counter(name for name, _ in spans)
    lengths = ctx["traced"]["lengths"]
    calls = len(layers(ctx["config"])) * len(lengths)
    if not spans or count["seg_rfft_kernel"] != calls \
            or count["banded_bins_kernel"] != calls \
            or count["bwd_bins_kernel"]:
        return None
    bound = 0.0
    for n in lengths:
        work = causal.layer_calls(ctx["config"], t["batch"], n)
        bound += work["seg_rfft"].bound_s() + work["mix"].bound_s()
    bound *= len(layers(ctx["config"]))
    return 100.0 * bound / sum(s for _, s in spans)

"""The causal kernels' work: frozen copies of the program's work models
(``fft_tpu_torch/utils/prof.py``: ``MixCost``, ``fft_ops``,
``_causal_parts``, ``fused_causal_mix_cost``, ``fused_causal_mix_bwd_cost``,
``kf_seg_rfft_cost``), so that a change to the program cannot move the
yardstick.  They count the function, not an implementation: each input
byte read once, each output byte written once, 2.5 n log2 n operations a
real FFT of n points, complex products and adds as real operations.  A
call's bound is the larger of its bytes over the HBM peak and its
operations over the fp32 peak (the transforms run in fp32 in every
instance)."""

from __future__ import annotations

import dataclasses
import math

from cardbench.workmodels import PEAKS


@dataclasses.dataclass(frozen=True)
class Work:
    flops: float
    hbm_bytes: float

    def bound_s(self) -> float:
        """The least seconds the card could take for the call."""
        return max(self.hbm_bytes / PEAKS["hbm_bytes_per_s"],
                   self.flops / PEAKS["fp32_flops_per_s"])


def fft_ops(n: int) -> float:
    """Operations of one real FFT of length n."""
    return 2.5 * n * math.log2(n)


def _parts(b, nc, chunk, d, cols, bytes_per_el):
    """(bytes of v or y, bytes of the K pairs the banded sum reads, the
    banded complex multiply-adds' operations, one pass of segment FFTs'
    operations); only K[c, j] with j <= c is ever read, and K is fp32 in
    every instance."""
    tri = nc * (nc + 1) // 2
    return (bytes_per_el * b * nc * chunk * d,
            4 * 2 * b * tri * (chunk + 1) * cols,
            8 * b * d * tri * (chunk + 1),
            b * d * nc * fft_ops(2 * chunk))


def mix(b, nc, chunk, d, cols, bytes_per_el=4) -> Work:
    """#7 (and #6, the direct #6): v and K's lower triangle read, y
    written; the windows' FFTs of 2C, the banded multiply-adds and the
    inverse FFTs."""
    act, kb, mac, seg = _parts(b, nc, chunk, d, cols, bytes_per_el)
    return Work(flops=2 * seg + mac, hbm_bytes=2 * act + kb)


def mix_bwd(b, nc, chunk, d, cols, bytes_per_el=4) -> Work:
    """#11 (and #10): v, ybar and K read, vbar and Kbar written; three
    passes of window FFTs and two of banded multiply-adds."""
    act, kb, mac, seg = _parts(b, nc, chunk, d, cols, bytes_per_el)
    return Work(flops=3 * seg + 2 * mac, hbm_bytes=3 * act + 2 * kb)


def seg_rfft(b, n, chunk, lanes) -> Work:
    """#9: the gate kernels read, each segment's spectrum of 2C written; one
    FFT of 2C a segment and lane."""
    nc = n // chunk
    return Work(flops=b * lanes * nc * fft_ops(2 * chunk),
                hbm_bytes=(4 * b * n * lanes
                           + 4 * 2 * b * nc * (chunk + 1) * lanes))


# The launches of #9, #7 and #11 (``csrc/causal_long.cu``), by the name
# the profiler gives their kernels; #7 and #11 each launch
# window_fft_kernel and chunk_inverse_kernel, and banded_bins_kernel (#7)
# or bwd_bins_kernel (#11) once a call.
KERNELS = ("seg_rfft_kernel", "window_fft_kernel", "banded_bins_kernel",
           "bwd_bins_kernel", "chunk_inverse_kernel")
CALL_KERNEL = {"seg_rfft": "seg_rfft_kernel", "mix": "banded_bins_kernel",
               "mix_bwd": "bwd_bins_kernel"}


def layer_calls(cfg: dict, b: int, n: int) -> dict:
    """The work of one call of #9, #7 and #11 of a SPECTRE layer of ``cfg``
    over b rows of n tokens: {"seg_rfft": Work, "mix": Work, "mix_bwd":
    Work}."""
    chunk = min(cfg["causal_chunk"], n)
    nc = n // chunk
    d = cfg["embed_dim"]
    cols = cfg["num_heads"] * cfg["gate_groups"]
    bpe = 2 if cfg["compute_dtype"] == "bfloat16" else 4
    return {"seg_rfft": seg_rfft(b, n, chunk, nc * cols),
            "mix": mix(b, nc, chunk, d, cols, bpe),
            "mix_bwd": mix_bwd(b, nc, chunk, d, cols, bpe)}

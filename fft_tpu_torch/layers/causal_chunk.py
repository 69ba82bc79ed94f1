"""The reference's causal chunk choice (copy of ``preferred_causal_chunk``,
``fft_tpu/layers/causal_seg.py:34-80``, with the TPU plan predicates it
calls, ``fft_tpu/kernels/pallas_causal.py:327-419, :758-808`` and
``pallas_fft.py:55-74``).

The chunk is part of the model, not a tuning knob of the port: it sets the
lag of the causal gate descriptor (``causal_chunk_gates``), so another chunk
gives other logits.  A preset that takes its chunk from this function
(``spectre_350m_config``) must therefore get the reference's chunk for every
sequence length, and these are the TPU's VMEM byte models on purpose.  They
say nothing about what the port's Hopper kernels take: that is
``fft_tpu_torch.kernels.causal``'s predicates.  Kept as a copy because
importing ``fft_tpu`` pulls in JAX; ``tests/test_torch_long_context.py``
holds the two in step.
"""

from __future__ import annotations

_DBLK = 128
_MiB = 1024 * 1024


def _mix_factors(n_fft: int):
    """(f1, f2) plan of the TPU kernels' in-kernel DFT of length n_fft / 2,
    or None."""
    if n_fft % 2 or n_fft < 8:
        return None
    n2 = n_fft // 2
    f1 = min(n2, 128)
    if n2 % f1:
        return None
    f2 = n2 // f1
    if f2 > 128:
        return None
    return f1, f2


def _pad8(x: int) -> int:
    return -(-x // 8) * 8


def _fused_vmem_ok(nc: int, chunk: int, dblk: int, itemsize: int = 4,
                   scr_bf16: bool = False, staged: bool = False,
                   cols: int = 32, dense_fwd: bool = False) -> bool:
    f2p = _pad8(chunk + 1)
    n = nc * chunk
    ncg = nc * cols
    scr_item = 2 if scr_bf16 else 4
    vin = (n + chunk) * dblk * itemsize * 2
    out = n * dblk * itemsize * 2
    kblk = f2p * max(ncg, 128) * scr_item * 2 * 2
    psel = nc * ncg * max(32, 128) * 4
    vscr = nc * f2p * dblk * scr_item * 2
    acc = nc * f2p * dblk * scr_item * 2
    if staged:
        amat = 6 * chunk * 2 * dblk * 4
    else:
        amat = int(chunk * f2p * 4 * 2 * 2 * 1.36)
    fmat = f2p * 2 * chunk * 4 * 2 if dense_fwd else 0
    total = vin + out + kblk + psel + vscr + acc + amat + fmat
    return total < 96 * _MiB


def _fused_plan(nc: int, chunk: int, d: int, itemsize: int = 2,
                fast: bool = False, cols: int = 32):
    scr_opts = (False,) if not fast else (False, True)
    dense_opts = (True, False) if chunk <= 1024 else (False,)
    for scr in scr_opts:
        for dense_fwd in dense_opts:
            for staged in (False, True):
                for dblk in (512, 256, 128):
                    if d % dblk or dblk > d:
                        continue
                    if _fused_vmem_ok(nc, chunk, dblk, itemsize, scr,
                                      staged, cols, dense_fwd):
                        return dblk, staged, scr, dense_fwd
    return None


def _v3_kb(nc: int, cols: int):
    ncg = nc * cols
    if cols % 128 == 0:
        return cols, 1
    if ncg <= 128:
        return ncg, nc
    if ncg % 128 == 0 and 128 % cols == 0:
        return 128, 128 // cols
    return None, None


def _v3_vmem_ok(nc: int, chunk: int, dblk: int, itemsize: int,
                scr_bf16: bool, staged: bool, cols: int) -> bool:
    kb, _ = _v3_kb(nc, cols)
    if kb is None:
        return False
    f2p = _pad8(chunk + 1)
    scr_item = 2 if scr_bf16 else 4
    vwin = 2 * chunk * dblk * itemsize * 2
    out = chunk * dblk * itemsize * 2
    kblk = f2p * max(kb, 128) * scr_item * 2 * 2
    vscr = 2 * nc * f2p * dblk * scr_item
    acc = 2 * f2p * dblk * 4
    if staged:
        amat = 6 * chunk * 2 * dblk * 4
    else:
        amat = int(chunk * f2p * 4 * 2 * 2 * 1.36)
    total = vwin + out + kblk + vscr + acc + amat + 4 * _MiB
    return total < 96 * _MiB


def _fused_plan_v3(nc: int, chunk: int, d: int, itemsize: int = 2,
                   fast: bool = False, cols: int = 32):
    if (d % _DBLK or chunk % 8 or not 128 <= chunk <= 2048
            or not 1 <= nc <= 64 or _mix_factors(2 * chunk) is None):
        return None
    scr_opts = (False,) if not fast else (False, True)
    for scr in scr_opts:
        for staged in (False, True):
            for dblk in (512, 256, 128):
                if d % dblk or dblk > d:
                    continue
                if _v3_vmem_ok(nc, chunk, dblk, itemsize, scr, staged,
                               cols):
                    return dblk, staged, scr
    return None


def reference_fused_mix_supported(nc: int, chunk: int, d: int,
                                  fast: bool = True, cols: int = 32) -> bool:
    """``pallas_causal.fused_mix_supported``: the TPU's v2-or-v3 plan
    predicate (VMEM byte models of a v5e)."""
    if d % _DBLK or chunk % 8 or not 128 <= chunk <= 2048 or not nc >= 1:
        return False
    if nc > 64 or _mix_factors(2 * chunk) is None:
        return False
    return (_fused_plan(nc, chunk, d, 2, fast, cols) is not None
            or _fused_plan_v3(nc, chunk, d, 2, fast, cols) is not None)


def preferred_causal_chunk(seq: int, d: int, fast: bool = True,
                           g_groups: int = 32, train: bool = False) -> int:
    """The reference's chunk for a causal block of length ``seq`` and width
    ``d``: 256 at seq 1k, 512 at 2k-4k, 1024 at 8k, 2048 from 16k (its
    sweep on a TPU v5e, ``fft_tpu/layers/causal_seg.py:36-61``), the first
    candidate that the TPU plan predicate accepts."""
    if seq <= 8192:
        if seq <= 2048:
            pref = [min(512, seq // 4)]
        elif seq == 4096:
            pref = [1024, 512] if train else [512, 1024]
        else:
            pref = [1024, 512]
        cands = pref + [seq // 8, seq // 16]
    else:
        cands = [seq // 4] if seq // 4 >= 512 else []
        cands += [seq // 8, seq // 16]
        if seq // 32 >= 2048:
            cands.append(seq // 32)
    for c in dict.fromkeys(cands):
        if (c >= 128 and seq % c == 0
                and reference_fused_mix_supported(seq // c, c, d, fast,
                                                  g_groups)):
            return c
    return max(128, seq // 16)

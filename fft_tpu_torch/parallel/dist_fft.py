"""Sequence-parallel spectral mixing as the distributed four-step FFT
(mirror of ``fft_tpu/parallel/dist_fft.py``).

With n = N1 * N2 and the sequence sharded over the ``seq`` axis of S ranks:

    1. DFT_N1 along the shard-local factor      (torch.fft: cuFFT)
    2. twiddle exp(-2 pi i n1 k2 / n)           (pointwise)
    3. the transpose                            (one all-to-all)
    4. DFT_N2 along the other factor
    gate (and memory) on the permuted (k1, k2) grid, k = k1 + N1 k2
    the inverse: the same stages mirrored.

The stage order and the permuted frequency layout are the JAX package's,
so the gate's gradient is the same math; the JAX package's DFT stages are
``matfft._cfft`` einsums, here ``torch.fft.fft`` along the factor's axis
(cuFFT on the card, as the port's ``fft_impl="matmul"``).  Where GSPMD
inserts its reshards from sharding constraints, ``comm.all_to_all`` is
called: 4 for the contiguous layout (``sp_spectral_mix``), 2 for the
strided one (``sp_spectral_mix_strided``), and as many again in the
backward (their adjoints).  The transform is complex-of-real, as JAX's.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from fft_tpu_torch.parallel import comm

_MAX_RADIX = 128


def _prime_factors(n: int) -> Optional[List[int]]:
    out = []
    m = n
    for p in (2, 3, 5, 7, 11, 13):
        while m % p == 0:
            out.append(p)
            m //= p
    if m != 1:
        return None if m > _MAX_RADIX else out + [m]
    return out


@functools.lru_cache(maxsize=None)
def cfft_factors(n: int) -> Optional[Tuple[int, ...]]:
    """A copy of the JAX package's ``matfft.cfft_factors``: its radix plan
    for a complex DFT of length n (factors <= 128), None if a prime factor
    exceeds 128.  The four-step plans below take a factor only where it has
    one, so they are JAX's plans; the port's stages are cuFFT's."""
    if n < 1:
        return None
    if n == 1:
        return (1,)
    if n & (n - 1) == 0:
        k = n.bit_length() - 1
        m = math.ceil(k / 7)
        m8 = math.ceil(k / 8)
        if m8 < m:
            m = m8
        base, rem = divmod(k, m)
        return tuple(2 ** (base + (1 if i < rem else 0)) for i in range(m))
    primes = _prime_factors(n)
    if primes is None:
        return None
    primes.sort(reverse=True)
    factors: List[int] = []
    for p in primes:
        for i, f in enumerate(factors):
            if f * p <= _MAX_RADIX:
                factors[i] = f * p
                break
        else:
            factors.append(p)
    factors.sort(reverse=True)
    return tuple(factors)


@functools.lru_cache(maxsize=None)
def _twiddle2_np(n1: int, n2: int, sign: int) -> np.ndarray:
    ang = (sign * 2.0 * np.pi / (n1 * n2)) * np.outer(np.arange(n1),
                                                      np.arange(n2))
    return np.exp(1j * ang).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _freq_map_np(n: int, n1: int):
    """Global frequency k(k1, k2) = k1 + n1 k2 on the half spectrum:
    (half index, conjugation sign, self-conjugate mask), each (n1, n2)."""
    n2 = n // n1
    k = np.arange(n1)[:, None] + n1 * np.arange(n2)[None, :]
    half = np.minimum(k, n - k)
    conj = np.where(k > n - k, -1.0, 1.0)
    self_conj = (k == 0) | (k == n - k)
    return half.astype(np.int64), conj.astype(np.float32), self_conj


@functools.lru_cache(maxsize=None)
def _tables(n: int, n1: int, device: str):
    half, conj, self_conj = _freq_map_np(n, n1)
    return (torch.from_numpy(half.ravel()).to(device),
            torch.from_numpy(conj).to(device),
            torch.from_numpy(self_conj).to(device))


@functools.lru_cache(maxsize=None)
def _twiddle(n1: int, n2: int, sign: int, device: str) -> torch.Tensor:
    return torch.from_numpy(_twiddle2_np(n1, n2, sign)).to(device)


def _full_gate(gate_half: torch.Tensor, n: int, n1: int) -> torch.Tensor:
    """The half-spectrum filter's Hermitian extension onto the permuted
    (k1, k2) grid: G[k] up to n/2, conj(G[n-k]) beyond, real parts at DC
    and Nyquist (the irfft convention the layer relies on).
    gate_half (..., F_half) complex -> (..., n1, n2) complex."""
    half, conj, self_conj = _tables(n, n1, str(gate_half.device))
    g = gate_half.index_select(-1, half).reshape(
        *gate_half.shape[:-1], n1, n // n1)
    re, im = g.real, g.imag * conj
    return torch.complex(re, torch.where(self_conj, torch.zeros_like(im),
                                         im))


def sp_plan(n: int, seq_shards: int) -> int:
    """N1 (the shard-major factor): the smallest multiple of the shard count
    that keeps both factors radix-decomposable."""
    n1 = seq_shards
    while n1 <= n:
        if n % n1 == 0 and cfft_factors(n1) and cfft_factors(n // n1):
            return n1
        n1 += seq_shards
    raise ValueError(f"no four-step plan for n={n}, shards={seq_shards}")


def sp_plan_strided(n: int, seq_shards: int) -> int:
    """N1 for the strided (2-all-to-all) layout: the shard count divides
    both factors; balanced factors preferred."""
    s = seq_shards
    best = None
    n1 = s
    while n1 * s <= n:
        if (n % n1 == 0 and (n // n1) % s == 0
                and cfft_factors(n1) and cfft_factors(n // n1)):
            if best is None or abs(math.log(n1 * n1 / n)) < abs(
                    math.log(best * best / n)):
                best = n1
        n1 += s
    if best is None:
        raise ValueError(
            f"no strided four-step plan for n={n}, shards={s} "
            f"(needs s | N1 and s | N2)")
    return best


def sp_stride_permute(x: torch.Tensor, n1: int, n2: int,
                      inverse: bool = False, dim: int = -2) -> torch.Tensor:
    """Natural <-> strided sequence layout: strided position p = b n1 + a
    holds natural index t = a n2 + b, so a contiguous shard of the strided
    layout holds one residue class of the four-step's minor index b."""
    dim = dim % x.dim()
    lead, n, tail = x.shape[:dim], x.shape[dim], x.shape[dim + 1:]
    if n != n1 * n2:
        raise ValueError(f"sequence {n} != {n1} x {n2}")
    rows = (n2, n1) if inverse else (n1, n2)
    xr = x.reshape(*lead, *rows, *tail).transpose(dim, dim + 1)
    return xr.reshape(*lead, n, *tail)


def _check(v: torch.Tensor, n_fft: int, s: int) -> None:
    if v.shape[1] * s != n_fft:
        raise ValueError(f"the SP mix runs on the whole window: {s} shards "
                         f"of {v.shape[1]} positions != n_fft {n_fft}")


def _spectra_of(gate_half, memory_fft, n_fft, n1):
    """(gate (B, d, n1, n2), memory (d, n1, n2) or None) on the grid."""
    gate2 = _full_gate(gate_half.movedim(-2, -1), n_fft, n1)
    mem2 = (None if memory_fft is None
            else _full_gate(memory_fft.movedim(-2, -1), n_fft, n1))
    return gate2, mem2


def sp_spectral_mix(v: torch.Tensor, gate_half: torch.Tensor,
                    memory_fft: Optional[torch.Tensor], *, n_fft: int,
                    mesh, seq_axis: str = "seq") -> torch.Tensor:
    """y = irfft(gate_half * rfft(v) [+ memory]) with the sequence
    contiguous over ``mesh[seq_axis]``: v (B, n_fft / S, d) real, this
    rank's positions; gate_half (B, F_half, d) and memory_fft (F_half, d)
    complex, the same on every rank.  Returns this rank's (B, n_fft / S,
    d) fp32.  Four all-to-alls, as the JAX package's."""
    s, r = mesh.size(seq_axis), mesh.rank(seq_axis)
    _check(v, n_fft, s)
    n1 = sp_plan(n_fft, s)
    n2 = n_fft // n1
    if n2 % s:
        raise ValueError(f"n_fft {n_fft}: the plan's N2 = {n2} does not "
                         f"split over {s} shards")
    b, nl, d = v.shape
    dev = str(v.device)
    bl, cl = slice(r * n2 // s, (r + 1) * n2 // s), \
        slice(r * n1 // s, (r + 1) * n1 // s)
    z = v.float().reshape(b, n1 // s, n2, d).to(torch.complex64)
    z = comm.all_to_all(z, mesh, seq_axis, 2, 1)        # a2a: b-sharded
    z = torch.fft.fft(z, dim=1)                          # DFT over a -> c
    z = z * _twiddle(n1, n2, -1, dev)[None, :, bl, None]
    z = comm.all_to_all(z, mesh, seq_axis, 1, 2)        # a2a: c-sharded
    z = torch.fft.fft(z, dim=2)                          # DFT over b -> kq
    # the spectrum S[c, kq] = X[c + n1 kq], sharded over c
    gate2, mem2 = _spectra_of(gate_half, memory_fft, n_fft, n1)
    z = z * gate2.permute(0, 2, 3, 1)[:, cl]
    if mem2 is not None:
        z = z + mem2.permute(1, 2, 0)[None, cl]
    z = torch.fft.ifft(z, dim=2)                         # kq -> b
    z = z * _twiddle(n1, n2, 1, dev)[None, cl, :, None]
    z = comm.all_to_all(z, mesh, seq_axis, 2, 1)        # a2a: b-sharded
    y = torch.fft.ifft(z, dim=1).real                    # c -> a
    y = comm.all_to_all(y, mesh, seq_axis, 1, 2)        # a2a: a-sharded
    return y.reshape(b, nl, d)


def sp_spectral_mix_strided(v: torch.Tensor, gate_half: torch.Tensor,
                            memory_fft: Optional[torch.Tensor], *,
                            n_fft: int, mesh,
                            seq_axis: str = "seq") -> torch.Tensor:
    """The 2-all-to-all mix: v (B, n_fft / S, d) is this rank's shard of
    the strided layout (``sp_stride_permute``), which holds whole residue
    classes of the minor index b, so the outer DFT stages are shard-local
    and only the two mid-transform transposes move data.  Returns this
    rank's shard of y in the strided layout."""
    s, r = mesh.size(seq_axis), mesh.rank(seq_axis)
    _check(v, n_fft, s)
    n1 = sp_plan_strided(n_fft, s)
    n2 = n_fft // n1
    b, nl, d = v.shape
    dev = str(v.device)
    bl, cl = slice(r * n2 // s, (r + 1) * n2 // s), \
        slice(r * n1 // s, (r + 1) * n1 // s)
    z = v.float().reshape(b, n2 // s, n1, d).to(torch.complex64)
    z = torch.fft.fft(z, dim=2)                          # DFT over a -> c
    z = z * _twiddle(n1, n2, -1, dev).T[None, bl, :, None]
    z = comm.all_to_all(z, mesh, seq_axis, 2, 1)        # a2a #1: c-sharded
    z = torch.fft.fft(z, dim=1)                          # DFT over bb -> kq
    # the spectrum S[kq, c] = X[c + n1 kq], sharded over c
    gate2, mem2 = _spectra_of(gate_half, memory_fft, n_fft, n1)
    z = z * gate2.permute(0, 3, 2, 1)[:, :, cl]
    if mem2 is not None:
        z = z + mem2.permute(2, 1, 0)[None, :, cl]
    z = torch.fft.ifft(z, dim=1)                         # kq -> bb
    z = z * _twiddle(n1, n2, 1, dev).T[None, :, cl, None]
    z = comm.all_to_all(z, mesh, seq_axis, 1, 2)        # a2a #2: b-sharded
    y = torch.fft.ifft(z, dim=2).real                    # c -> a
    return y.reshape(b, nl, d)

"""The port's sequence-parallel mix (fft_tpu_torch/parallel/dist_fft.py)
against the JAX package's on its 8-fake-device mesh: the four-step plans,
both mixes forward and backward at (S, n) = (2, 64), (4, 64), (4, 128)
with and without memory, their all-to-all counts (4 and 2, as
tests/test_dist_fft.py asserts of JAX's compiled modules), the SP block in
both layouts and with the wavelet, and the strided layout's refusals.

The port's ranks run over gloo in spawned processes
(tests/torch_parallel_worker.py), one spawn per world size.  Tolerances
(tests/golden_utils.py's rel_err): 2e-5 forward, as JAX's own sharded
tests, 1e-4 for gradients."""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import fft_tpu.config as jcfg
import fft_tpu.kernels.matfft as jmatfft
from fft_tpu.layers import spectre_block_apply, spectre_block_init
from fft_tpu.parallel import dist_fft as jdf, make_mesh
from fft_tpu_torch.config import SpectreConfig
from fft_tpu_torch.convert import block_from_jax_params, block_to_jax_params
from fft_tpu_torch.layers.spectre import spectre_block_init as port_block
from fft_tpu_torch.parallel import dist_fft as tdf
from tests import torch_parallel_worker as worker
from tests.golden_utils import rel_err

FWD_TOL = 2e-5
GRAD_TOL = 1e-4
# XLA's CPU backend at optimisation level 0: half the compile time of the
# JAX references, the same results at these tolerances
FAST_COMPILE = {"xla_backend_optimization_level": 0}

# (S, n, memory): the mixes held against JAX's
MIX_CASES = {2: [(64, True)], 4: [(64, False), (128, True)]}
PLAN_NS = [2 ** k for k in range(1, 17)] + [12, 24, 96, 160, 192, 320,
                                            384, 768, 1536, 6144]


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_sp_plans_match_jax(shards):
    for n in PLAN_NS:
        for ours, theirs in ((tdf.sp_plan, jdf.sp_plan),
                             (tdf.sp_plan_strided, jdf.sp_plan_strided)):
            try:
                want = theirs(n, shards)
            except ValueError:
                with pytest.raises(ValueError):
                    ours(n, shards)
                continue
            assert ours(n, shards) == want, (ours.__name__, n, shards)


def test_cfft_factors_match_jax():
    for n in [*range(0, 1100), 2 ** 15, 2 ** 16, 3 * 2 ** 12, 127 * 4,
              131, 262]:
        assert tdf.cfft_factors(n) == jmatfft.cfft_factors(n), n


def jit_run(fn, *args, **jit_kw):
    """jax.jit(fn, **jit_kw)(*args), compiled with ``FAST_COMPILE``."""
    return jax.jit(fn, **jit_kw).lower(*args).compile(
        compiler_options=FAST_COMPILE)(*args)


def _seq_sharded(mesh, x):
    return jax.lax.with_sharding_constraint(
        x, NamedSharding(mesh, P(None, "seq", None)))


def _mix_case(n, memory, seed):
    rng = np.random.default_rng(seed)
    b, d, f = 2, 8, n // 2 + 1

    def cplx(*shape):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(np.complex64)

    return dict(n=n, v=rng.standard_normal((b, n, d)).astype(np.float32),
                gate=cplx(b, f, d), mem=cplx(f, d) if memory else None,
                w=rng.standard_normal((b, n, d)).astype(np.float32))


def _jax_mix(c, shards, layout):
    """JAX's sharded mix of a case: (y, dL/dv, dL/dgate) of sum(y * w) in
    the natural order."""
    mesh = make_mesh(data=1, seq=shards, model=1)
    n = c["n"]
    mem = None if c["mem"] is None else jnp.asarray(c["mem"])

    def run(v, gate):
        if layout == "strided":
            n1 = jdf.sp_plan_strided(n, shards)
            vs = _seq_sharded(mesh, jdf.sp_stride_permute(v, n1, n // n1))
            ys = jdf.sp_spectral_mix_strided(vs, gate, mem, n_fft=n,
                                             mesh=mesh)
            return jdf.sp_stride_permute(ys, n1, n // n1, inverse=True)
        return jdf.sp_spectral_mix(_seq_sharded(mesh, v), gate, mem, n_fft=n,
                                   mesh=mesh)

    def loss(v, gate):
        y = run(v, gate)
        return jnp.sum(y * c["w"]), y

    (_, y), (gv, gg) = jit_run(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True), c["v"], c["gate"])
    # jax.grad of a complex input is the conjugate of torch's
    return np.asarray(y), np.asarray(gv), np.conj(np.asarray(gg))


def _natural(parts, n, shards, layout):
    """The ranks' shards of a (B, n, d) tensor, in the natural order."""
    x = np.concatenate([np.asarray(p) for p in parts], axis=1)
    if layout == "strided":
        n1 = tdf.sp_plan_strided(n, shards)
        x = np.asarray(tdf.sp_stride_permute(
            torch.from_numpy(x), n1, n // n1, inverse=True))
    return x


def _block_cfg(**kw):
    base = dict(embed_dim=32, num_heads=4, n_fft=64, pooling_type="mean",
                wavelet_on_rate=0.0, memory_size=8, fft_impl="matmul")
    base.update(kw)
    return SpectreConfig(**base)


def _jax_block(cfg, params, x, w, layout, shards=4):
    """JAX's sharded block: (y, grads of the parameters, dL/dx) of
    sum(y * w), as tests/test_dist_fft.py runs it."""
    jc = jcfg.SpectreConfig(**dataclasses.asdict(cfg))
    mesh = make_mesh(data=1, seq=shards, model=1)
    n = x.shape[1]

    def loss(params, x):
        if layout == "strided":
            n1 = jdf.sp_plan_strided(n, shards)
            xs = _seq_sharded(mesh, jdf.sp_stride_permute(x, n1, n // n1))
            y = jdf.sp_stride_permute(
                spectre_block_apply(params, jc, xs, sp_mesh=mesh,
                                    sp_layout="strided"), n1, n // n1,
                inverse=True)
        else:
            y = spectre_block_apply(params, jc, _seq_sharded(mesh, x),
                                    sp_mesh=mesh)
        return jnp.sum(y * w), y

    (_, y), (gp, gx) = jit_run(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True), params, x)
    return np.asarray(y), jax.tree.map(np.asarray, gp), np.asarray(gx)


BLOCKS = [("contiguous", {}), ("strided", {}),
          ("contiguous", dict(wavelet_on_rate=1.0, memory_size=0))]


def _refusal_messages(refusals):
    """JAX's errors for blocks the strided layout refuses."""
    msgs = []
    mesh = make_mesh(data=1, seq=4, model=1)
    x = jnp.zeros((1, 64, 32))
    for c in refusals:
        jc = jcfg.SpectreConfig(**dataclasses.asdict(c["cfg"]))
        params = spectre_block_init(jax.random.key(0), jc)
        try:
            spectre_block_apply(params, jc, x, sp_mesh=mesh,
                                sp_layout="strided")
            msgs.append(None)
        except ValueError as e:
            msgs.append(str(e))
    return msgs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each world size's ranks, spawned once for every case of the module
    (both spawns run while JAX computes the references), the inputs and
    JAX's results."""
    out, spawned = {}, {}
    for shards, cases in MIX_CASES.items():
        mixes = [_mix_case(n, mem, 10 * shards + i)
                 for i, (n, mem) in enumerate(cases)]
        blocks, refusals = [], []
        if shards == 4:
            rng = np.random.default_rng(7)
            for i, (layout, kw) in enumerate(BLOCKS):
                cfg = _block_cfg(**kw)
                sd = port_block(cfg, torch.Generator().manual_seed(i),
                                "cpu").state_dict()
                blocks.append(dict(
                    cfg=cfg, params=block_to_jax_params(sd, cfg),
                    layout=layout, sd=sd,
                    x=rng.standard_normal((2, 64, 32)).astype(np.float32),
                    w=rng.standard_normal((2, 64, 32)).astype(np.float32)))
            refusals = [dict(cfg=_block_cfg(wavelet_on_rate=0.5), n=64),
                        dict(cfg=_block_cfg(pooling_type="dct"), n=64)]
        payload = dict(mixes=mixes, refusals=refusals,
                       blocks=[{k: b[k] for k in ("cfg", "sd", "layout",
                                                  "x", "w")}
                               for b in blocks])
        spawned[shards] = worker.start(shards, {"mixes": payload},
                                       tmp_path_factory.mktemp("mix"))
        out[shards] = dict(mixes=mixes, blocks=blocks, refusals=refusals)
    # JAX's references, a few at a time (XLA compiles outside the GIL)
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        for shards, o in out.items():
            o["jax_mixes"] = [{layout: pool.submit(_jax_mix, c, shards,
                                                   layout)
                               for layout in ("contiguous", "strided")}
                              for c in o["mixes"]]
            o["jax_blocks"] = [pool.submit(_jax_block, b["cfg"], b["params"],
                                           b["x"], b["w"], b["layout"])
                               for b in o["blocks"]]
            o["jax_refusals"] = _refusal_messages(o["refusals"])
    for o in out.values():
        o["jax_mixes"] = [{k: f.result() for k, f in m.items()}
                          for m in o["jax_mixes"]]
        o["jax_blocks"] = [f.result() for f in o["jax_blocks"]]
    for shards, r in spawned.items():
        out[shards]["ranks"] = [x["mixes"] for x in r.results()]
    return out


@pytest.mark.parametrize("shards,index", [(2, 0), (4, 0), (4, 1)])
@pytest.mark.parametrize("layout", ["contiguous", "strided"])
def test_sp_mix_matches_jax(runs, shards, index, layout):
    """Forward and the cotangents of v and of the gate, against JAX's
    sharded mix and its jax.grad; 4 all-to-alls a contiguous mix, 2 a
    strided one, as many in the backward."""
    c = runs[shards]["mixes"][index]
    got = [r["mixes"][index][layout] for r in runs[shards]["ranks"]]
    y, gv, gg = runs[shards]["jax_mixes"][index][layout]
    n = c["n"]
    assert rel_err(_natural([g["y"] for g in got], n, shards, layout),
                   y) < FWD_TOL
    assert rel_err(_natural([g["v_grad"] for g in got], n, shards, layout),
                   gv) < GRAD_TOL
    assert rel_err(sum(np.asarray(g["gate_grad"]) for g in got),
                   gg) < GRAD_TOL
    count = 4 if layout == "contiguous" else 2
    assert all(g["a2a_fwd"] == count and g["a2a_bwd"] == count for g in got)


@pytest.mark.parametrize("index", range(len(BLOCKS)))
def test_sp_block_matches_jax(runs, index):
    """The whole block (mean pooling and memory in both layouts; the
    wavelet at on_rate 1, contiguous) sequence parallel over 4 ranks:
    output, dL/dx and every parameter's gradient (summed over the ranks)
    against JAX's sharded block."""
    b = runs[4]["blocks"][index]
    got = [r["blocks"][index] for r in runs[4]["ranks"]]
    y, gp, gx = runs[4]["jax_blocks"][index]
    assert rel_err(_natural([g["y"] for g in got], 64, 4, b["layout"]),
                   y) < FWD_TOL
    assert rel_err(_natural([g["x_grad"] for g in got], 64, 4,
                            b["layout"]), gx) < GRAD_TOL
    want = block_from_jax_params(gp, b["cfg"])
    for name, ref in want.items():
        if name == "memory_fft":
            continue                     # a frozen buffer: no gradient
        total = sum(np.asarray(g["grads"][name]) for g in got)
        assert rel_err(total, ref.numpy()) < GRAD_TOL, name


def test_strided_layout_refuses_order_sensitive_blocks(runs):
    """JAX's messages (the wavelet's, then DCT pooling's), raised on every
    rank before any collective."""
    msgs = runs[4]["jax_refusals"]
    assert all(msgs) and "wavelet refinement" in msgs[0] \
        and "order-invariant pooler" in msgs[1]
    for r in runs[4]["ranks"]:
        assert r["errors"] == msgs

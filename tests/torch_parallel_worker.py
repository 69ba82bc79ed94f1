"""Rank functions of the port's parallel tests (tests/test_torch_dist_fft.py,
test_torch_parallel.py, test_torch_parallel_cli.py).

The tests compute the JAX package's references in their own process, on
the 8-fake-device mesh, then ``run`` spawns the ranks of a gloo process
group (``torch.multiprocessing``), each with one thread, which load the
test's inputs, run the case functions of ``CASES`` that the payload names
and save what they got.  This module
imports no JAX: a spawned child imports it, and would otherwise start JAX
with its 8 fake devices.  Ranks meet through a file store in the test's
``tmp_path`` (so concurrent test workers never collide), or, for the
torchrun case, through torchrun's environment on a free localhost port.
"""

from __future__ import annotations

import contextlib
import faulthandler
import os
import socket

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# a rank that has not finished by then prints its stack and exits, so a
# deadlocked collective fails the test instead of hanging it
RANK_TIMEOUT_S = 360


def _main(rank: int, world: int, tmp: str, port: int) -> None:
    faulthandler.dump_traceback_later(RANK_TIMEOUT_S, exit=True)
    torch.set_num_threads(1)
    from fft_tpu_torch.parallel import distributed_init
    if port:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                          MASTER_PORT=str(port))
    else:
        distributed_init(f"file://{tmp}/store", world, rank, "cpu")
    payloads = torch.load(f"{tmp}/payload.pt", weights_only=False)
    out = {case: CASES[case](rank, world, p) for case, p in payloads.items()}
    torch.save(out, f"{tmp}/rank{rank}.pt")
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    faulthandler.cancel_dump_traceback_later()


class Run:
    """Ranks spawned by ``start``; ``results`` waits for them."""

    def __init__(self, world: int, tmp: str, context):
        self.world, self.tmp, self.context = world, tmp, context

    def results(self) -> list:
        """Each rank's {case: result}, in rank order."""
        while not self.context.join():
            pass
        return [torch.load(f"{self.tmp}/rank{r}.pt", weights_only=False)
                for r in range(self.world)]


def start(world: int, payloads: dict, tmp_path, torchrun: bool = False
          ) -> Run:
    """Spawn ``world`` ranks, each running ``CASES[case](rank, world,
    payload)`` for every (case, payload) of ``payloads`` in order, and
    return at once (the test computes its JAX references meanwhile).
    ``torchrun``: the ranks get torchrun's environment instead of a file
    store (``distributed_init`` with no arguments reads it)."""
    tmp = os.path.join(str(tmp_path), f"world{world}")
    os.makedirs(tmp, exist_ok=True)
    torch.save(payloads, f"{tmp}/payload.pt")
    context = mp.spawn(_main, args=(world, tmp, _free_port() if torchrun
                                    else 0), nprocs=world, join=False)
    return Run(world, tmp, context)


def run(world: int, payloads: dict, tmp_path, torchrun: bool = False
        ) -> list:
    """``start`` and wait: each rank's {case: result}, in rank order."""
    return start(world, payloads, tmp_path, torchrun).results()


@contextlib.contextmanager
def one_rank_group(tmp_path):
    """A 1-rank gloo group in this process, destroyed on exit."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store1",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _grads(module) -> dict:
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p))
            .detach().clone() for n, p in module.named_parameters()}


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

def _mixes(rank, world, p):
    """Both SP mixes: this rank's outputs, cotangents of v and of the gate
    (a replicated input: the test sums the ranks'), the all-to-all counts
    of a forward and of its backward; then the SP blocks."""
    from fft_tpu_torch.layers.spectre import SpectreBlock
    from fft_tpu_torch.parallel import comm, dist_fft, make_mesh
    from fft_tpu_torch.parallel.mesh import seq_slice
    mesh = make_mesh(1, world, 1, device="cpu")
    out = {"mixes": [], "blocks": [], "errors": []}
    for c in p["mixes"]:
        n = c["n"]
        n1 = dist_fft.sp_plan_strided(n, world)
        sl = seq_slice(mesh, n)
        res = {}
        for layout in ("contiguous", "strided"):
            v, w = _t(c["v"]), _t(c["w"])
            if layout == "strided":
                v = dist_fft.sp_stride_permute(v, n1, n // n1)
                w = dist_fft.sp_stride_permute(w, n1, n // n1)
                mix = dist_fft.sp_spectral_mix_strided
            else:
                mix = dist_fft.sp_spectral_mix
            v = v[:, sl].clone().requires_grad_()
            gate = _t(c["gate"]).clone().requires_grad_()
            mem = None if c["mem"] is None else _t(c["mem"])
            comm.reset_calls()
            y = mix(v, gate, mem, n_fft=n, mesh=mesh)
            fwd = comm.CALLS["all_to_all"]
            (y * w[:, sl]).sum().backward()
            res[layout] = dict(y=y.detach(), v_grad=v.grad,
                               gate_grad=gate.grad, a2a_fwd=fwd,
                               a2a_bwd=comm.CALLS["all_to_all"] - fwd)
        out["mixes"].append(res)
    for c in p["blocks"]:
        cfg = c["cfg"]
        block = SpectreBlock(cfg)
        block.load_state_dict(c["sd"])
        block.eval()
        x, w = _t(c["x"]), _t(c["w"])
        n = x.shape[1]
        if c["layout"] == "strided":
            n1 = dist_fft.sp_plan_strided(n, world)
            x = dist_fft.sp_stride_permute(x, n1, n // n1)
            w = dist_fft.sp_stride_permute(w, n1, n // n1)
        sl = seq_slice(mesh, n)
        xl = x[:, sl].clone().requires_grad_()
        y = block(xl, sp_mesh=mesh, sp_layout=c["layout"])
        (y * w[:, sl]).sum().backward()
        out["blocks"].append(dict(y=y.detach(), x_grad=xl.grad,
                                  grads=_grads(block)))
    for c in p["refusals"]:
        block = SpectreBlock(c["cfg"])
        try:
            block(torch.zeros(1, c["n"] // world, c["cfg"].embed_dim),
                  sp_mesh=mesh, sp_layout="strided")
            out["errors"].append(None)
        except ValueError as e:
            out["errors"].append(str(e))
    return out


def _causal(rank, world, p):
    """Causal blocks, sequence parallel: this rank's output, cotangent of
    x and the parameters' (the test sums them)."""
    from fft_tpu_torch.layers.spectre import SpectreBlock
    from fft_tpu_torch.parallel import make_mesh
    from fft_tpu_torch.parallel.mesh import seq_slice
    mesh = make_mesh(1, world, 1, device="cpu")
    out = []
    for c in p["cases"]:
        block = SpectreBlock(c["cfg"])
        block.load_state_dict(c["sd"])
        block.eval()
        x, w = _t(c["x"]), _t(c["w"])
        sl = seq_slice(mesh, x.shape[1])
        xl = x[:, sl].clone().requires_grad_()
        y = block(xl, sp_mesh=mesh)
        (y * w[:, sl]).sum().backward()
        out.append(dict(y=y.detach(), x_grad=xl.grad, grads=_grads(block)))
    return out


def _cp(rank, world, p):
    """Context-parallel sliding-window attention: this rank's output and
    the cotangents of its q, k, v."""
    from fft_tpu_torch.layers.attention import sliding_window_attention_cp
    from fft_tpu_torch.parallel import make_mesh
    from fft_tpu_torch.parallel.mesh import seq_slice
    mesh = make_mesh(1, world, 1, device="cpu")
    out = []
    for c in p["cases"]:
        sl = seq_slice(mesh, c["q"].shape[1])
        qkv = [_t(c[k])[:, sl].clone().requires_grad_() for k in "qkv"]
        y = sliding_window_attention_cp(*qkv, c["window"], mesh)
        (y * _t(c["w"])[:, sl]).sum().backward()
        out.append(dict(y=y.detach(), grads=[t.grad for t in qkv]))
    return out


def _pp(rank, world, p):
    """GPipe over ``world`` stages: the output (every stage's) and this
    stage's blocks' gradients of sum(y^2)."""
    from fft_tpu_torch.layers.spectre import SpectreBlock
    from fft_tpu_torch.parallel import make_stage_mesh
    from fft_tpu_torch.parallel.pipeline import pipeline_apply
    mesh = make_stage_mesh(world, device="cpu")
    out = []
    for c in p["cases"]:
        per = len(c["sds"]) // world
        blocks = []
        for sd in c["sds"][rank * per:(rank + 1) * per]:
            blk = SpectreBlock(c["cfg"])
            blk.load_state_dict(sd)
            blocks.append(blk.eval())
        y = pipeline_apply(blocks, lambda b, h: b(h), _t(c["x"]), mesh=mesh,
                           num_microbatches=c["micro"])
        res = dict(y=y.detach())
        if c["grads"]:
            (y ** 2).sum().backward()
            res["grads"] = [_grads(b) for b in blocks]
        out.append(res)
    return out


def _tp_block(rank, world, p):
    """A non-causal block (the wavelet on) head parallel over ``world``
    ranks: its output, dL/dx and every gradient, summed (``sync_grads``)
    and gathered into the single-device layout."""
    from fft_tpu_torch.layers.spectre import SpectreBlock
    from fft_tpu_torch.parallel import gather_state_dict, make_mesh, \
        shard_model
    from fft_tpu_torch.parallel.mesh import sync_grads
    mesh = make_mesh(1, 1, world, device="cpu")
    block = SpectreBlock(p["cfg"])
    block.load_state_dict(p["sd"])
    shard_model(block.eval(), mesh)
    x = _t(p["x"]).clone().requires_grad_()
    y = block(x, tp_mesh=mesh)
    (y * _t(p["w"])).sum().backward()
    grads = _grads(block)
    sync_grads(grads.items(), mesh)
    return dict(y=y.detach(), x_grad=x.grad,
                grads=gather_state_dict(grads, mesh))


def _lm_step(rank, world, p):
    """One train_step of the LM under each (data, seq, model) layout of
    ``world`` ranks: loss, grad_norm and the gathered gradients."""
    from fft_tpu_torch.models.lm import SpectreLM
    from fft_tpu_torch.parallel import gather_state_dict, make_mesh, \
        shard_model
    from fft_tpu_torch.train import TrainConfig, train_init, train_step
    out = {}
    for layout in p["layouts"]:
        mesh = make_mesh(*layout, device="cpu")
        model = SpectreLM(p["cfg"])
        model.load_state_dict(p["sd"])
        shard_model(model, mesh)
        state = train_init(model, TrainConfig(), seed=1)
        m = train_step(state, _t(p["batch"]), mesh=mesh)
        out[layout] = dict(loss=float(m["loss"]),
                           grad_norm=float(m["grad_norm"]),
                           grads=gather_state_dict(_grads(model), mesh))
    return out


def _cli(rank, world, p):
    """``cli.main`` on each of ``p["runs"]`` ((tag, argv)): the metrics
    every rank logged (its own record of the logger's calls; only the
    primary writes the file) and the multihost queries."""
    from fft_tpu_torch import cli
    from fft_tpu_torch.parallel import multihost
    from fft_tpu_torch.utils import metrics
    logged = []
    log = metrics.MetricsLogger.log

    def spy(self, step, rec, tokens=None):
        logged.append({"step": int(step), "loss": float(rec["loss"])})
        return log(self, step, rec, tokens)

    metrics.MetricsLogger.log = spy
    out = {"runs": {}}
    for tag, argv in p["runs"]:
        logged.clear()
        cli.main(list(argv))
        out["runs"][tag] = list(logged)
    out.update(rank=multihost.process_index(),
               primary=multihost.is_primary(),
               batch_slice=multihost.global_batch_slice(8))
    return out


CASES = {"mixes": _mixes, "causal": _causal, "cp": _cp, "pp": _pp,
         "tp_block": _tp_block, "lm_step": _lm_step, "cli": _cli}

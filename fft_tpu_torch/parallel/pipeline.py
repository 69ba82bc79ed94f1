"""Pipeline parallelism: GPipe over a ``stage`` axis (mirror of
``fft_tpu/parallel/pipeline.py``).

Rank r holds layers [r L / P, (r + 1) L / P) (``mesh.shard_model`` cuts a
model down to them).  The batch is cut into M microbatches that flow
through the stages over M + P - 1 steps: at step t stage r runs its layers
on microbatch t - r (stage 0 takes it from the input, the others from the
previous stage) and sends the result on, as the JAX package's ring
``ppermute``; a stage with no microbatch at a step sends zeros and runs
nothing.  The JAX package's final ``psum`` of the last stage's masked
output becomes a broadcast from the last stage.

The whole schedule is one autograd Function.  Its forward keeps each
microbatch's graph through the stage's blocks; its backward runs the
schedule in reverse, M + P - 1 steps in which each stage backpropagates
one microbatch's cotangent through its blocks (their parameters' gradients
accumulate, as under a reentrant checkpoint) and sends the input's
cotangent to the previous stage: the send's adjoint.  So every rank issues
the same collectives in the same order in both directions, whatever the
autograd engine's order.  The stages follow the replicated convention of
``parallel/comm.py``: the last stage's output cotangent is the one that
counts, and the input's cotangent (stage 0's) is summed over the stages so
that every stage holds it, with the same gradients of what the stages hold
in common (embeddings, final LayerNorm).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from fft_tpu_torch.parallel import comm


def _schedule(blocks, apply_block, x_mb, mesh, axis, keep: bool):
    """The forward schedule: (y (M, mb, ...) of the last stage, on every
    stage; {microbatch: (input leaf, output)} when ``keep``)."""
    stages, stage = mesh.size(axis), mesh.rank(axis)
    m = x_mb.shape[0]
    graphs = {}
    recv = torch.zeros_like(x_mb[0])
    ys = []
    for t in range(m + stages - 1):
        i = t - stage
        if 0 <= i < m:
            inp = (x_mb[i] if stage == 0 else recv).detach()
            with torch.set_grad_enabled(keep):
                out = inp.requires_grad_(keep)
                for block in blocks:
                    out = apply_block(block, out)
            if keep:
                graphs[i] = (inp, out)
            out = out.detach()
            if stage == stages - 1:
                ys.append(out)
        else:
            out = torch.zeros_like(recv)
        recv = comm.stage_send_recv(out, mesh, axis, 1)
    y = torch.stack(ys) if ys else torch.zeros_like(x_mb)
    return comm.broadcast(y, mesh, axis, stages - 1), graphs


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_mb, blocks, apply_block, mesh, axis, *params):
        y, graphs = _schedule(blocks, apply_block, x_mb, mesh, axis, True)
        ctx.state = (graphs, mesh, axis, len(params))
        return y

    @staticmethod
    def backward(ctx, gy):
        graphs, mesh, axis, n_params = ctx.state
        stages, stage = mesh.size(axis), mesh.rank(axis)
        m = gy.shape[0]
        g_in = torch.zeros_like(gy)
        recv = torch.zeros_like(gy[0])
        for tau in range(m + stages - 1):
            i = m - 1 - (tau - (stages - 1 - stage))
            if 0 <= i < m:
                inp, out = graphs.pop(i)
                g_out = gy[i] if stage == stages - 1 else recv
                torch.autograd.backward(out, g_out)
                send = (inp.grad if inp.grad is not None
                        else torch.zeros_like(recv))
                g_in[i] = send
            else:
                send = torch.zeros_like(recv)
            recv = comm.stage_send_recv(send, mesh, axis, -1)
        if stage != 0:
            g_in.zero_()
        g_in = comm._all_reduce(g_in, mesh, axis, "copy_to")
        return (g_in,) + (None,) * (4 + n_params)


def pipeline_apply(blocks: Sequence, apply_block: Callable,
                   h: torch.Tensor, *, mesh, stage_axis: str = "stage",
                   num_microbatches: int = None) -> torch.Tensor:
    """Run this stage's ``blocks`` (``apply_block(block, x) -> x``) as one
    stage of the whole stack over ``mesh[stage_axis]``.  h (B, ...) is the
    input of layer 0, the same on every stage; returns the last layer's
    output (B, ...) on every stage."""
    m = num_microbatches or mesh.size(stage_axis)
    b = h.shape[0]
    if b % m:
        raise ValueError(f"batch {b} does not split into {m} microbatches")
    x_mb = h.reshape(m, b // m, *h.shape[1:])
    params = [p for blk in blocks for p in blk.parameters()
              if p.requires_grad]
    if torch.is_grad_enabled() and (h.requires_grad or params):
        y = _Pipeline.apply(x_mb, blocks, apply_block, mesh, stage_axis,
                            *params)
    else:
        y = _schedule(blocks, apply_block, x_mb, mesh, stage_axis, False)[0]
    return y.reshape(b, *h.shape[1:])

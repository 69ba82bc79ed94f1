"""The device mesh and the sharding rule (mirror of
``fft_tpu/parallel/mesh.py``).

Axes, one process per card:

- ``data``:  the batch (DP);
- ``seq``:   the sequence (SP/CP: the distributed FFT's all-to-alls, the
  causal mix's halo and all-gather, the sliding window's halo);
- ``model``: the heads (TP).  SPECTRE's heads have independent parameters
  and meet only at ``out_proj``, so head-parallel compute needs no
  collective until the out_proj sum, Megatron's layout.

A ``Mesh`` wraps a ``torch.distributed.device_mesh.DeviceMesh`` and is used
only for its process groups: the model holds plain local tensors (its
shards) and the explicit collectives of ``parallel/comm.py``, never
``DTensor``s, on which the kernels' autograd Functions have no rules.

The rule (``model_shard_dim``) is the JAX package's ``_spec_for`` on the
port's ``state_dict`` keys: heads' parameters on their head axis,
``out_proj`` and ``mlp.fc2`` weights on their input dim, ``mlp.fc1``'s on its
output dim, ``tok_emb`` on its vocab, everything else replicated.  A
pipeline (``make_stage_mesh``) holds the blocks ``blocks.<i>`` of its stage.
``shard_state_dict`` and ``gather_state_dict`` turn a full state into a
rank's shard and back, so checkpoints stay in the single-device format.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from fft_tpu_torch.parallel import comm
from fft_tpu_torch.utils.device import resolve_device

AXES = ("data", "seq", "model")


def world_size_error(needed: int, flags: str) -> ValueError:
    have = dist.get_world_size() if dist.is_initialized() else 1
    return ValueError(
        f"{flags} need a process group of {needed} processes, this one has "
        f"{have}: launch one process per card, e.g. torchrun "
        f"--nproc-per-node {needed} -m fft_tpu_torch.cli ...")


class Mesh:
    """Named axes over the default process group: each axis's group, this
    rank's coordinate on it and its size."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        names = device_mesh.mesh_dim_names
        self.shape = {n: device_mesh.size(i) for i, n in enumerate(names)}
        self._groups = {n: device_mesh.get_group(n) for n in names}
        self._ranks = {n: device_mesh.get_local_rank(n) for n in names}

    def group(self, axis: str):
        return self._groups[axis]

    def rank(self, axis: str) -> int:
        return self._ranks.get(axis, 0)

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)


def _device_mesh(shape: Tuple[int, ...], names: Tuple[str, ...], device,
                 flags: str) -> Mesh:
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise world_size_error(n, flags)
    dev = resolve_device(device)
    return Mesh(init_device_mesh(dev.type, shape, mesh_dim_names=names))


def make_mesh(data: int = 1, seq: int = 1, model: int = 1,
              device=None) -> Mesh:
    """A (data, seq, model) mesh over all processes of the default group
    (``parallel.multihost.distributed_init``), whose size must be the
    product.  ``device``: the card unless ``"cpu"``."""
    return _device_mesh((data, seq, model), AXES, device,
                        f"--dp {data} --sp {seq} --tp {model}")


def make_stage_mesh(stages: int, device=None) -> Mesh:
    """A pipeline's ('stage',) mesh over all processes."""
    return _device_mesh((stages,), ("stage",), device, f"--pp {stages}")


# ---------------------------------------------------------------------------
# the sharding rule
# ---------------------------------------------------------------------------

def model_shard_dim(key: str) -> Optional[int]:
    """The dim of a port ``state_dict`` entry sharded on ``model``, or None
    (replicated): JAX's ``_spec_for`` in the port's layout (PyTorch weights
    are (out, in), JAX's (in, out); per block, not stacked)."""
    parts = key.split(".")
    if "heads" in parts:
        return 0
    if parts[-2:] == ["out_proj", "weight"]:
        return 1
    if "mlp" in parts and parts[-2:] == ["fc1", "weight"]:
        return 0
    if "mlp" in parts and parts[-2:] == ["fc2", "weight"]:
        return 1
    if key == "tok_emb":
        return 0
    return None


def _block_index(key: str) -> Optional[int]:
    parts = key.split(".")
    return int(parts[1]) if parts[0] == "blocks" else None


def _renumber(key: str, index: int) -> str:
    parts = key.split(".")
    return ".".join([parts[0], str(index), *parts[2:]])


def shard_state_dict(full: Dict[str, torch.Tensor],
                     mesh: Optional[Mesh] = None,
                     pp_mesh: Optional[Mesh] = None
                     ) -> Dict[str, torch.Tensor]:
    """This rank's shard of a full state (model or optimizer moments, keyed
    by parameter name): its stage's blocks renumbered from 0 under
    ``pp_mesh``, its ``model`` slice of each sharded entry under ``mesh``."""
    out = {}
    per = stage0 = 0
    if pp_mesh is not None:
        layers = 1 + max(i for i in map(_block_index, full) if i is not None)
        stages = pp_mesh.size("stage")
        if layers % stages:
            raise ValueError(f"{layers} layers do not split into {stages} "
                             "pipeline stages")
        per = layers // stages
        stage0 = pp_mesh.rank("stage") * per
    for key, t in full.items():
        i = _block_index(key)
        if pp_mesh is not None and i is not None:
            if not stage0 <= i < stage0 + per:
                continue
            key = _renumber(key, i - stage0)
        dim = None if mesh is None else model_shard_dim(key)
        if dim is not None:
            parts = mesh.size("model")
            if t.shape[dim] % parts:
                raise ValueError(f"{key}: dim {dim} of {tuple(t.shape)} "
                                 f"does not split over {parts} model ranks")
            t = t.chunk(parts, dim)[mesh.rank("model")]
        out[key] = t.clone()
    return out


def gather_state_dict(local: Dict[str, torch.Tensor],
                      mesh: Optional[Mesh] = None,
                      pp_mesh: Optional[Mesh] = None
                      ) -> Dict[str, torch.Tensor]:
    """The full state from every rank's shard (``shard_state_dict``
    inverted); every rank of the groups calls it and every rank gets it."""
    out = {}
    per = 1 + max((i for i in map(_block_index, local) if i is not None),
                  default=-1)
    for key, t in local.items():
        dim = None if mesh is None else model_shard_dim(key)
        if dim is not None:
            t = comm.gather_tensor(t, mesh, "model", dim)
        i = _block_index(key)
        if pp_mesh is not None and i is not None:
            stacked = comm.gather_tensor(t[None], pp_mesh, "stage", 0)
            for s in range(pp_mesh.size("stage")):
                out[_renumber(key, s * per + i)] = stacked[s]
        else:
            out[key] = t
    return out


def shard_model(model: nn.Module, mesh: Optional[Mesh] = None,
                pp_mesh: Optional[Mesh] = None) -> nn.Module:
    """Cut ``model`` (a ``SpectreLM``, or a ``HybridLM`` under a mesh
    without model parallelism) down to this rank's shard in place: each
    parameter and buffer becomes its local slice, and under ``pp_mesh``
    ``model.blocks`` keeps its stage's blocks only.  Returns ``model``."""
    local = shard_state_dict(model.state_dict(), mesh, pp_mesh)
    if pp_mesh is not None:
        per = len(model.blocks) // pp_mesh.size("stage")
        first = pp_mesh.rank("stage") * per
        model.blocks = nn.ModuleList(model.blocks[first:first + per])
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.data = local[name].to(p.device)
        for name, b in model.named_buffers():
            b.data = local[name].to(b.device)
    return model


# ---------------------------------------------------------------------------
# batches, gradients and their norm
# ---------------------------------------------------------------------------

def _part(n: int, parts: int, index: int, what: str) -> slice:
    if n % parts:
        raise ValueError(f"{what} {n} does not split over {parts} ranks")
    per = n // parts
    return slice(index * per, (index + 1) * per)


def data_slice(mesh: Mesh, batch: int) -> slice:
    """This rank's rows of a global batch (JAX's ``lm_batch_sharding``)."""
    return _part(batch, mesh.size("data"), mesh.rank("data"), "batch")


def seq_slice(mesh: Mesh, n: int) -> slice:
    """This rank's positions of an n-token sequence under SP."""
    return _part(n, mesh.size("seq"), mesh.rank("seq"), "sequence")


def model_partial(key: str) -> bool:
    """A replicated parameter whose gradient each ``model`` rank holds a
    share of: the MLP's biases (``layers.spectre.MLP`` under TP)."""
    parts = key.split(".")
    return "mlp" in parts and parts[-1] == "bias"


def sync_grads(named_grads: Iterable[Tuple[str, torch.Tensor]],
               mesh: Mesh) -> None:
    """Complete the gradients in place: the MLP biases' shares summed over
    ``model``, then every gradient (every parameter is replicated over
    ``data`` and ``seq``) summed over those axes; one flat all-reduce
    each."""
    named_grads = list(named_grads)
    comm.sum_([g for n, g in named_grads if model_partial(n)], mesh,
              "model")
    grads = [g for _, g in named_grads]
    for axis in ("data", "seq"):
        comm.sum_(grads, mesh, axis)


def global_grad_norm(named_grads: Iterable[Tuple[str, torch.Tensor]],
                     mesh: Optional[Mesh] = None,
                     pp_mesh: Optional[Mesh] = None) -> torch.Tensor:
    """optax's ``global_norm`` over the global tree: each ``model``-sharded
    parameter (and each stage's block) counted once across its ranks, each
    replicated one once."""
    rep, sharded, staged = [], [], []
    named_grads = list(named_grads)
    device = named_grads[0][1].device
    for name, g in named_grads:
        if pp_mesh is not None and _block_index(name) is not None:
            staged.append(g)
        elif mesh is not None and model_shard_dim(name) is not None:
            sharded.append(g)
        else:
            rep.append(g)

    def sq(ts):
        return (torch.stack(torch._foreach_norm(ts)).square().sum() if ts
                else torch.zeros((), device=device))

    total = sq(rep)
    if mesh is not None:
        total = total + comm.all_reduce(sq(sharded), mesh, "model")
    if pp_mesh is not None:
        total = total + comm.all_reduce(sq(staged), pp_mesh, "stage")
    return total.sqrt()

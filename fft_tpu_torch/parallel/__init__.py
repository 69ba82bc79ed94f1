"""Parallelism on ``torch.distributed`` (mirror of ``fft_tpu/parallel``):
the (data, seq, model) mesh and its sharding rule, the collectives with
their adjoints, the distributed four-step FFT, the GPipe pipeline and the
multi-process start-up.  The JAX package leans on GSPMD; here every
collective is an explicit call (``parallel/comm.py``), NCCL on the card,
gloo on the CPU."""

from fft_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, gather_state_dict, make_mesh, make_stage_mesh, model_shard_dim,
    shard_model, shard_state_dict,
)
from fft_tpu_torch.parallel.multihost import (  # noqa: F401
    distributed_init, is_primary,
)

__all__ = ["Mesh", "make_mesh", "make_stage_mesh", "model_shard_dim",
           "shard_state_dict", "gather_state_dict", "shard_model",
           "distributed_init", "is_primary"]

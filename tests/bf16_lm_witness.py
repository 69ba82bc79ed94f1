"""The readings behind the bf16 check of the long tiny LM in
``tests/test_torch_causal_long_nc.py`` (its reference, JAX traced with an
fp32-accumulated cumsum), on the CPU.

For each seed (BF16_SEEDS, or those given) at ``--seq`` (BF16_SEQ), each
gradient tensor's distance in JAX's own bf16-to-fp32 distance for it
(floored at BF16_TOL / 2), its median over tensors and its worst, for:

- port/jax: the port's bf16 run against JAX's jitted bf16 run;
- jax32sum/jax: JAX traced with the fp32-accumulated cumsum against plain
  JAX, two sound bf16 runs of one program that differ only in how the
  chunk gates' prefix sum adds (XLA's CPU cumsum adds in bf16, torch's in
  fp32);
- jax eager/jit: JAX's eager bf16 run (``jax.disable_jit``) against its
  jitted one;
- port/jax32sum: what the test holds;
- lag L/jax32sum: the same with a #10 whose Kbar misses lag L (0, the
  nearest; -1, the farthest: the test's control, which must fail);

and the chunk gates alone (layer 0, head 0, a bf16 q from seed 1) against
fp32 at seq 512, 2048 and 8192: the port's, JAX's and their distance.

Run from the repo root:

    JAX_PLATFORMS=cpu python -m tests.bf16_lm_witness [--seq N] [SEED ...]
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import fft_tpu.config as jcfg_mod
import fft_tpu.layers.spectre as jsp
import fft_tpu.train as jtrain
import tests.test_torch_causal_long_nc as tl
from fft_tpu_torch.layers import spectre as tsp
from tests.golden_utils import rel_err
from tests.test_torch_convert import jax_lm_config, lm_pair


def _readings(grads) -> str:
    r = tl.grad_ratios(grads)
    return f"median {np.median(r):.3f} worst {np.max(r):.3f}"


def _eager_grads(cfg, params, batch):
    jcfg = jax_lm_config(cfg)
    with jax.disable_jit():
        grads = jax.grad(lambda p: jtrain.lm_loss(
            p, jcfg, jnp.asarray(batch), deterministic=True))(
                jax.tree.map(jnp.asarray, params))
    return jax.tree.leaves(jax.tree.map(np.asarray, grads))


def lm_readings(seed: int, seq: int) -> None:
    params, batch, ours16, jax32 = tl.bf16_case(seed, seq)
    cfg = tl.long_tiny_config(seq, "bfloat16")
    plain = tl.jax_lm_run(cfg, params, batch)
    port = tl.port_lm_run(cfg, seed, batch)[2]
    rows = {
        "port/jax": tl.bf16_grads(port, plain[2], jax32[2]),
        "jax32sum/jax": tl.bf16_grads(ours16[2], plain[2], jax32[2]),
        "jax eager/jit": tl.bf16_grads(_eager_grads(cfg, params, batch),
                                       plain[2], jax32[2]),
        "port/jax32sum": tl.bf16_grads(port, ours16[2], jax32[2]),
    }
    for lag in (0, -1):
        rows[f"lag {lag}/jax32sum"] = tl.bf16_grads(
            tl.port_lm_run(cfg, seed, batch, tl.drop_lag(lag))[2],
            ours16[2], jax32[2])
    print(f"seed {seed} seq {seq}:", flush=True)
    for name, grads in rows.items():
        print(f"  {name}: {_readings(grads)}", flush=True)


def gate_readings() -> None:
    for seq in (512, 2048, 8192):
        cfg = tl.long_tiny_config(seq, "bfloat16")
        nc = seq // cfg.block.causal_chunk
        params, model = lm_pair(cfg, seed=6)
        heads = model.blocks[0].mix.heads
        jheads = jax.tree.map(lambda a: jnp.asarray(a[0, 0]),
                              params["blocks"]["mix"]["heads"])
        jhcfg = jcfg_mod.SpectreHeadConfig(**dataclasses.asdict(heads.cfg))
        x = np.random.default_rng(1).standard_normal(
            (1, seq, cfg.block.num_heads, cfg.block.head_dim))
        with torch.no_grad():
            q32 = torch.einsum("bnhi,hoi->bnho", torch.from_numpy(x).float(),
                               heads.w_q)
            q16 = q32.bfloat16()
            port = tsp.causal_chunk_gates(heads, heads.cfg, q16, nc,
                                          128)[:, :, 0].numpy()

        def jgate(q):
            return np.asarray(jax.jit(lambda a: jsp.causal_chunk_gates(
                jheads, jhcfg, a, nc, 128))(q))

        want = jgate(jnp.asarray(q32[:, :, 0].numpy()))
        theirs = jgate(jnp.asarray(q16[:, :, 0].float().numpy(),
                                   jnp.bfloat16))
        print(f"gates seq {seq}: port/fp32 {rel_err(port, want):.4f} "
              f"jax/fp32 {rel_err(theirs, want):.4f} "
              f"port/jax {rel_err(port, theirs):.4f}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, default=tl.BF16_SEQ)
    ap.add_argument("seeds", type=int, nargs="*")
    args = ap.parse_args()
    gate_readings()
    for seed in args.seeds or tl.BF16_SEEDS:
        lm_readings(seed, args.seq)


if __name__ == "__main__":
    main()

"""The readings behind the bf16 gradient rule of
``tests/test_torch_hybrid.py`` (BF16_MEDIAN, BF16_WORST), on the CPU.

For each seed of BF16_SEEDS (or those given), each gradient tensor's
distance in JAX's own bf16-to-fp32 distance for it (floored at
BF16_TOL / 2), its median over tensors and its worst, for three pairs:

- port: the port's bf16 run against JAX's jitted bf16 run (what the test
  holds);
- fault: the same with a #10 whose Kbar misses its farthest lag (the
  test's control, which must fail);
- jax: JAX's eager bf16 run (``jax.disable_jit``) against its jitted one,
  two sound runs of one program that round in different places, the
  scatter that the rule has to leave room for.

Run from the repo root:

    JAX_PLATFORMS=cpu python -m tests.bf16_hybrid_witness [SEED ...]
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np

import fft_tpu.train.loop as jloop
import tests.test_torch_hybrid as th
from tests.golden_utils import rel_err


def _readings(ratios) -> str:
    return f"median {np.median(ratios):.3f} worst {np.max(ratios):.3f}"


def main(seeds) -> None:
    for seed in seeds:
        params, batch, out = th._bf16_case(seed)
        cfg = th.small_hybrid("bfloat16")
        jcfg = th.jax_hybrid_config(cfg)
        jp = jax.tree.map(jnp.asarray, params)
        with jax.disable_jit():
            grads = jax.grad(lambda p: jloop.hybrid_loss(
                p, jcfg, jnp.asarray(batch), deterministic=True))(jp)
        eager = th._jax_grads_by_name(grads, cfg)
        port = th._bf16_errs(seed)[2]
        fault = th._bf16_errs(seed, th._drop_last_lag)[2]
        jit16 = out["bfloat16"][2]
        jax_pair = {name: (rel_err(eager[name].numpy(),
                                   jit16[name].numpy()), own)
                    for name, (_, own) in port.items()}
        print(f"seed {seed}: "
              f"port {_readings(th._bf16_grad_ratios(port))}; "
              f"fault {_readings(th._bf16_grad_ratios(fault))}; "
              f"jax {_readings(th._bf16_grad_ratios(jax_pair))}",
              flush=True)


if __name__ == "__main__":
    main([int(s) for s in sys.argv[1:]] or th.BF16_SEEDS)

"""The plain reference of the benchmarked models, in float32.

Plain PyTorch, written from the models' equations (the SPECTRE paper,
arXiv 2502.18394, with the causal chunk gates, and a causal sliding-window
attention), independent of the program: nothing here imports the program,
JAX or the JAX package, and nothing reads what the program has made.  The
harness hands both sides the same weights and tokens, drawn from the seed
(``cardbench.weights``, ``cardbench.traffic``).

- ``model``: the parameters of a configuration, the forward passes of the
  SPECTRE LM and of the hybrid LM, and the decode cache a prefill builds;
- ``train``: the loss, AdamW and the first training steps, one batch row
  at a time, each block recomputed in backward, so that the 32k-token
  steps fit on one card.

``model.ROUNDERS`` names the precisions: ``"float32"``, the reference, and
``"float8"``, the control, which rounds every value that the program rounds
to bf16 to fp8 e4m3 instead (one scale a tensor), in the backward too.
"""

"""Command-line entry point (mirror of ``fft_tpu/cli.py``: ``train-lm`` and
``generate``).

Usage:
    python -m fft_tpu_torch.cli train-lm [--preset tiny|350m] [--steps N]
        [--batch B] [--seq L] [--lr LR] [--data FILE] [--metrics FILE]
        [--log-every N] [--eval-every N] [--seed S] [--device cuda|cpu]
    python -m fft_tpu_torch.cli generate [--preset tiny|350m] [--seq L]
        [--prompt TEXT] [--steps N] [--temperature T] [--seed S]
        [--device cuda|cpu]

Random weights from ``--seed``; byte-level tokens (ids below 256, in the
350M's 50432-entry vocab too, as the JAX CLI does without ``--vocab``).
Both run on the card unless ``--device cpu`` is given; without a card they
fail at once.  Training runs on a text file, or, for the tiny preset, on
the synthetic corpus when no ``--data`` is given (the JAX CLI builds a BPE
corpus for the 350M there, which is not ported).
Flags of the JAX CLI whose modules are still queued raise
``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np
import torch


# ROADMAP.md items ('Modules to port') of the flags not ported yet
_CKPT = "module 7, checkpoint, CLI and parallel/"
_PARALLEL = "module 7, DP/TP/SP/PP on torch.distributed"
_BPE = "module 7, BPE vocab and the tokenize command"
_BF16 = "bf16 fast mode"


def _not_ported(flag: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{flag} is not ported to fft_tpu_torch yet (see ROADMAP.md, "
        f"'Modules to port': {item})")


def _lm_config(args):
    """The preset's LMConfig at ``--seq`` (and ``--vocab-size``, if given)."""
    from fft_tpu_torch.models.lm import spectre_350m_config, tiny_lm_config
    vocab = ({"vocab_size": args.vocab_size}
             if getattr(args, "vocab_size", None) else {})
    make = spectre_350m_config if args.preset == "350m" else tiny_lm_config
    return make(seq=args.seq, **vocab)


def cmd_train_lm(args) -> None:
    from fft_tpu_torch.models.lm import lm_init
    from fft_tpu_torch.train import TrainConfig, lm_loss, train_init, \
        train_step
    from fft_tpu_torch.train.data import CharDataset
    from fft_tpu_torch.utils import MetricsLogger, resolve_device

    if args.preset == "350m" and args.data is None:
        # the JAX CLI trains the 350M on a BPE corpus it builds here
        raise _not_ported("--preset 350m without --data (a BPE corpus)",
                          _BPE)
    for flag, value, item in (
            ("--ckpt", args.ckpt, _CKPT), ("--resume", args.resume, _CKPT),
            ("--bf16", args.bf16, _BF16),
            ("--profile", args.profile, "module 7, utils/prof.py"),
            ("--dp", args.dp > 1, _PARALLEL), ("--sp", args.sp > 1, _PARALLEL),
            ("--tp", args.tp > 1, _PARALLEL), ("--pp", args.pp > 1, _PARALLEL),
            ("--vocab-size past 256",
             args.vocab_size is not None and args.vocab_size > 256, _BPE)):
        if value:
            raise _not_ported(flag, item)
    if args.data is not None and (
            args.data.endswith(".tokens")
            or pathlib.Path(args.data + ".vocab.json").exists()):
        raise _not_ported("a .tokens BPE corpus", _BPE)

    device = resolve_device(args.device)
    cfg = _lm_config(args)
    model = lm_init(cfg, torch.Generator().manual_seed(args.seed), device)
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps)
    state = train_init(model, tcfg, seed=args.seed + 1)

    data = CharDataset(path=args.data)
    batches = data.batches(args.batch, args.seq, seed=args.seed)
    eval_batches = None
    if args.eval_every:
        # a separately seeded held-out stream, as the JAX CLI
        eval_batches = data.batches(args.batch, args.seq,
                                    seed=args.seed + 7919)
    logger = MetricsLogger(args.metrics, print_every=args.log_every)
    tokens_per_step = args.batch * args.seq
    try:
        for i, batch in zip(range(args.steps), batches):
            metrics = train_step(state, batch)
            if i % args.log_every == 0 or i == args.steps - 1:
                rec = {"loss": metrics["loss"],
                       "grad_norm": metrics["grad_norm"]}
                if eval_batches is not None and i % args.eval_every == 0:
                    model.eval()
                    with torch.no_grad():
                        ce = float(lm_loss(model, torch.as_tensor(
                            next(eval_batches)).to(device, torch.int64)))
                    model.train()
                    rec["eval_loss"] = ce
                    rec["eval_ppl"] = float(np.exp(min(ce, 20.0)))
                logger.log(i, rec, tokens=tokens_per_step)
    finally:
        logger.close()


def cmd_generate(args) -> None:
    from fft_tpu_torch.models.lm import lm_generate, lm_init
    from fft_tpu_torch.utils import resolve_device

    for flag, value, item in (("--ckpt", args.ckpt, _CKPT),
                              ("--vocab", args.vocab, _BPE),
                              ("--vocab-size", args.vocab_size, _BPE),
                              ("--bf16", args.bf16, _BF16)):
        if value:
            raise _not_ported(flag, item)
    device = resolve_device(args.device)
    cfg = _lm_config(args)
    model = lm_init(cfg, torch.Generator().manual_seed(args.seed), device)
    prompt_ids = torch.from_numpy(
        np.frombuffer(args.prompt.encode("utf-8"), np.uint8)
        .astype(np.int64))[None].to(device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    toks = lm_generate(model, prompt_ids, steps=args.steps, generator=gen,
                       temperature=args.temperature)
    text = bytes(int(t) % 256 for t in toks[0].tolist()).decode(
        "utf-8", errors="replace")
    print(args.prompt + text)


def main(argv=None):
    p = argparse.ArgumentParser(prog="fft_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    lm = sub.add_parser("train-lm")
    lm.add_argument("--preset", default="tiny", choices=["tiny", "350m"])
    lm.add_argument("--steps", type=int, default=1000)
    lm.add_argument("--batch", type=int, default=8)
    lm.add_argument("--seq", type=int, default=2048)
    lm.add_argument("--lr", type=float, default=3e-4)
    lm.add_argument("--data", default=None, help="UTF-8 text corpus")
    lm.add_argument("--vocab-size", type=int, default=None,
                    help="override the preset's vocab size (at most 256)")
    lm.add_argument("--ckpt", default=None)
    lm.add_argument("--resume", action="store_true")
    lm.add_argument("--bf16", action="store_true")
    lm.add_argument("--metrics", default=None, help="JSONL metrics file")
    lm.add_argument("--log-every", type=int, default=10)
    lm.add_argument("--eval-every", type=int, default=0,
                    help="held-out loss/perplexity every N steps")
    lm.add_argument("--profile", default=None)
    lm.add_argument("--dp", type=int, default=1)
    lm.add_argument("--sp", type=int, default=1)
    lm.add_argument("--tp", type=int, default=1)
    lm.add_argument("--pp", type=int, default=1)
    lm.add_argument("--seed", type=int, default=0)
    lm.add_argument("--device", default="cuda",
                    help="torch device: cuda (the default) or cpu")
    lm.set_defaults(fn=cmd_train_lm)

    gen = sub.add_parser("generate")
    gen.add_argument("--preset", default="tiny", choices=["tiny", "350m"])
    gen.add_argument("--seq", type=int, default=2048)
    gen.add_argument("--bf16", action="store_true")
    gen.add_argument("--ckpt", default=None)
    gen.add_argument("--prompt", default="the ")
    gen.add_argument("--steps", type=int, default=64)
    gen.add_argument("--temperature", type=float, default=0.0)
    gen.add_argument("--vocab", default=None)
    gen.add_argument("--vocab-size", type=int, default=None)
    gen.add_argument("--seed", type=int, default=0)
    gen.add_argument("--device", default="cuda",
                     help="torch device: cuda (the default) or cpu")
    gen.set_defaults(fn=cmd_generate)
    args = p.parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Command-line entry point (mirror of ``fft_tpu/cli.py``: ``train-lm``,
``train-hybrid``, ``train-vit``, ``tokenize`` and ``generate``).

Usage:
    python -m fft_tpu_torch.cli train-lm [--preset tiny|350m] [--steps N]
        [--batch B] [--seq L] [--lr LR] [--data FILE] [--vocab-size V]
        [--ckpt DIR] [--ckpt-every N] [--resume] [--metrics FILE]
        [--log-every N] [--eval-every N] [--seed S] [--bf16]
        [--profile DIR] [--dp N] [--sp N] [--tp N] [--pp N]
        [--device cuda|cpu]
    python -m fft_tpu_torch.cli tokenize --out FILE [--data TEXT]
        [--vocab-size V] [--max-merges M] [--chars N]
    python -m fft_tpu_torch.cli generate [--preset tiny|350m] [--seq L]
        [--ckpt DIR] [--vocab FILE] [--vocab-size V] [--prompt TEXT]
        [--steps N] [--temperature T] [--seed S] [--bf16]
        [--device cuda|cpu]
    python -m fft_tpu_torch.cli train-hybrid [--preset tiny|1b] [--steps N]
        [--batch B] [--seq L] [--lr LR] [--data FILE] [--ckpt DIR]
        [--ckpt-every N] [--resume] [--bf16] [--metrics FILE]
        [--log-every N] [--eval-every N] [--seed S] [--profile DIR]
        [--dp N] [--sp N] [--device cuda|cpu]
    python -m fft_tpu_torch.cli train-vit [--steps N] [--batch B]
        [--data DIR] [--classes K] [--layers L] [--lr LR] [--ckpt DIR]
        [--ckpt-every N] [--resume] [--metrics FILE] [--log-every N]
        [--seed S] [--device cuda|cpu]
    python -m fft_tpu_torch.cli bench-mix [--seqs 1024,4096,16384]
        [--batch 8] [--dim 512] [--device cuda|cpu]

The training commands and ``generate`` run on the card unless ``--device
cpu`` is given; without a card they fail at once.  Training reads a text file or a
``.tokens`` BPE stream (with its ``.vocab.json`` sidecar, from
``tokenize``) through the native C++ loader, falling back to the Python
one as the JAX CLI does; without ``--data`` the tiny preset trains on the
synthetic corpus and the 350M on a BPE corpus built from it (cached under
``~/.cache/fft_tpu_torch/``).  ``--ckpt`` checkpoints every
``--ckpt-every`` steps and at the end, ``--resume`` continues from the
latest checkpoint (``python -m fft_tpu_torch.train.supervisor`` restarts a
failed run that way).  ``generate`` takes weights from ``--ckpt`` (else
random from ``--seed``) and a BPE tokenizer from ``--vocab`` (else bytes).
``--bf16`` runs the blocks in ``compute_dtype="bfloat16"`` (the parameters
stay fp32), as the JAX CLI's; on the card the causal mix runs the bf16
instances of its kernels (#6 and #10 on the tiny preset and the 350M's
short prompts, #7 and #11 on the 350M's long chunks).  ``--profile DIR``
writes a ``torch.profiler`` Chrome trace of one step after warm-up (the
third of the run, as the JAX CLI's) into DIR (``utils/prof.py``).  Beside
the ops and kernels it holds the program's spans, ``user_annotation``
events named ``fft_tpu_torch.<name>`` on the kernels' clock:
``train.step`` and its ``train.forward``, ``train.backward`` and
``train.optimizer``; ``spectre.block`` with its ``spectre.gates``,
``swa.block`` with its ``swa.attention``, and ``head_ce`` (each again
inside ``train.backward`` where the remat recomputes it); and
``swa.attention.backward``, the attention's backward.

Parallel training (``fft_tpu_torch.parallel``), one process per card::

    torchrun --nproc-per-node N -m fft_tpu_torch.cli train-lm --dp D \
        --sp S --tp T            # D * S * T == N
    torchrun --nproc-per-node P -m fft_tpu_torch.cli train-lm --pp P
    torchrun --nproc-per-node N -m fft_tpu_torch.cli train-hybrid \
        --dp D --sp S            # D * S == N

``main`` joins the process group first (``distributed_init``: NCCL on the
card, gloo with ``--device cpu``).  ``--dp/--sp/--tp`` build the (data,
seq, model) mesh, ``--pp`` alone a pipeline of P stages (the layers must
split evenly), as the JAX CLI; ``--sp`` switches the causal mix to the
segmented algorithm.  Flags whose product is not the group's size raise,
naming the size and the torchrun line.  ``--batch`` stays the global batch:
every rank draws the same seeded stream and takes its slice, so the losses
are the single-device run's.  Only the primary rank writes metrics and
checkpoints; a checkpoint is gathered into the single-device format, so
``--resume`` at any layout and ``generate --ckpt`` read it.

``train-hybrid`` trains the hybrid SPECTRE + sliding-window LM (config 5;
``--preset 1b`` is d=2048 at seq 32768 in bf16 with group remat) on
byte-level windows of ``--data`` or the synthetic corpus, as the JAX CLI's
``CharDataset``; ``train-vit`` trains the ViT (config 3) on an image
folder (``--data``, which sets ``--classes``) or synthetic
class-conditional images, with ``optax.adamw(lr)``'s update
(``vit_train_config``).  Both checkpoint and resume as ``train-lm``.

``bench-mix`` times the JAX CLI's bf16 block (``embed_dim=--dim``, 8
heads, n_fft = seq, mean pooling, no wavelet, ``fft_impl="auto"``, seed
0) at each of ``--seqs``: the forward chained 4 and 16 times, the slope a
forward (CUDA events on the card, the host clock on the CPU), and prints a
JSON line a seq with the JAX keys (``seq``, ``block_fwd_ms``,
``tokens_per_sec``, ``mix_roofline_ms``: ``spectral_mix_cost`` over the
H100's published peaks), the device and the mix branch the block took.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import pathlib
import statistics
import sys
import time

import numpy as np
import torch


def _lm_config(args):
    """The preset's LMConfig at ``--seq`` (and ``--vocab-size``, if given),
    its blocks in bf16 with ``--bf16``."""
    from fft_tpu_torch.models.lm import spectre_350m_config, tiny_lm_config
    vocab = ({"vocab_size": args.vocab_size}
             if getattr(args, "vocab_size", None) else {})
    make = spectre_350m_config if args.preset == "350m" else tiny_lm_config
    cfg = make(seq=args.seq, **vocab)
    if args.bf16:
        cfg = dataclasses.replace(cfg, block=dataclasses.replace(
            cfg.block, compute_dtype="bfloat16"))
    return cfg


def _default_bpe_corpus(vocab_size: int) -> str:
    """Build (once, cached) a BPE-tokenized synthetic corpus, so the
    50k-vocab preset trains on its declared vocab with no dataset on
    disk."""
    from fft_tpu_torch.train.bpe import is_token_file, tokenize_file
    from fft_tpu_torch.train.data import synthetic_corpus

    cache = pathlib.Path.home() / ".cache" / "fft_tpu_torch"
    cache.mkdir(parents=True, exist_ok=True)
    out = cache / f"synth_v{vocab_size}.tokens"
    if not is_token_file(str(out)):
        print(f"building BPE corpus at {out} ...")
        tokenize_file(synthetic_corpus(2_000_000), str(out),
                      vocab_size=vocab_size)
    return str(out)


def _check_vocab(tok_vocab: int, model_vocab: int) -> None:
    # user input: must survive python -O
    if tok_vocab > model_vocab:
        raise SystemExit(f"corpus vocab {tok_vocab} exceeds model vocab "
                         f"{model_vocab}")


def _make_batches(args, data_path, token_mode: bool, seed: int):
    """The training (or held-out) stream: the native loader over
    ``data_path``, else the Python loader, as the JAX CLI picks them."""
    from fft_tpu_torch.train.data import CharDataset, TokenDataset
    from fft_tpu_torch.train.native_loader import (NativeCharLoader,
                                                   NativeLoaderUnavailable)
    if data_path is not None:
        try:
            it = iter(NativeCharLoader(
                data_path, args.batch, args.seq, seed=seed,
                elem_size=2 if token_mode else 1))
            print("using native C++ data loader"
                  + (" (uint16 BPE tokens)" if token_mode else ""))
            return it
        except (NativeLoaderUnavailable, OSError) as e:
            print(f"native loader unavailable ({e}); using Python loader")
        if token_mode:
            return TokenDataset(data_path).batches(args.batch, args.seq,
                                                   seed=seed)
    return CharDataset(path=data_path).batches(args.batch, args.seq,
                                               seed=seed)


def _segmented(cfg):
    """cfg with the segmented causal mix: sequence parallelism needs the
    shard-local segmented algorithm (the 2N-FFT path is global)."""
    return dataclasses.replace(cfg, block=dataclasses.replace(
        cfg.block, causal_impl="segmented"))


def _lm_meshes(args, cfg, device):
    """(mesh, pp_mesh) of train-lm's flags: the (data, seq, model) mesh,
    or with ``--pp`` alone a pipeline; (None, None) for one process with
    no group and no flag (the single-device path)."""
    import torch.distributed as dist
    from fft_tpu_torch.parallel import make_mesh, make_stage_mesh
    if args.pp > 1:
        if (args.dp, args.sp, args.tp) != (1, 1, 1):
            raise ValueError("--pp composes with --dp/--sp/--tp through "
                             "several meshes, which this CLI keeps simple: "
                             "use --pp alone")
        if cfg.num_layers % args.pp:
            raise ValueError(f"{cfg.num_layers} layers do not split into "
                             f"--pp {args.pp} stages")
        return None, make_stage_mesh(args.pp, device)
    if args.dp * args.sp * args.tp == 1 and not dist.is_initialized():
        return None, None
    return make_mesh(args.dp, args.sp, args.tp, device), None


def _sharded(mesh, pp_mesh):
    """(gather, shard) state maps of a parallel run for its checkpoints,
    (None, None) for a single device."""
    from fft_tpu_torch.parallel import gather_state_dict, shard_state_dict
    if mesh is None and pp_mesh is None:
        return None, None
    return (functools.partial(gather_state_dict, mesh=mesh, pp_mesh=pp_mesh),
            functools.partial(shard_state_dict, mesh=mesh, pp_mesh=pp_mesh))


def _writers(args, gather):
    """(checkpoint writer or None, metrics logger): the primary rank
    writes, every rank gathers."""
    from fft_tpu_torch.parallel import is_primary
    from fft_tpu_torch.train.checkpoint import AsyncCheckpointWriter
    from fft_tpu_torch.utils import MetricsLogger
    primary = is_primary()
    ckpt_writer = (AsyncCheckpointWriter(args.ckpt, gather=gather,
                                         write=primary)
                   if args.ckpt else None)
    logger = MetricsLogger(args.metrics if primary else None,
                           print_every=args.log_every, echo=primary)
    return ckpt_writer, logger


def _all_written() -> None:
    """In a process group, wait until every rank is here: the primary has
    drained its checkpoint writes, so a run that resumes next (on any
    rank) sees them."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()


def cmd_train_lm(args) -> None:
    from fft_tpu_torch.models.lm import lm_init
    from fft_tpu_torch.parallel import shard_model
    from fft_tpu_torch.train import TrainConfig, lm_loss, train_init, \
        train_step
    from fft_tpu_torch.train.bpe import Tokenizer, is_token_file, \
        vocab_sidecar
    from fft_tpu_torch.utils import resolve_device

    device = resolve_device(args.device)
    cfg = _lm_config(args)
    if args.sp > 1 and cfg.block.causal:
        cfg = _segmented(cfg)
    mesh, pp_mesh = _lm_meshes(args, cfg, device)
    data_path = args.data
    if data_path is None and args.preset == "350m":
        data_path = _default_bpe_corpus(cfg.vocab_size)
    token_mode = is_token_file(data_path)
    if token_mode:
        _check_vocab(Tokenizer.load(vocab_sidecar(data_path)).vocab_size,
                     cfg.vocab_size)
    model = lm_init(cfg, torch.Generator().manual_seed(args.seed), device)
    if mesh is not None or pp_mesh is not None:
        shard_model(model, mesh, pp_mesh)
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps)
    state = train_init(model, tcfg, seed=args.seed + 1)
    gather, shard = _sharded(mesh, pp_mesh)
    start = _resume(args, state, shard)

    # Resumed runs re-seed by the resumed step so the stream continues with
    # fresh batches instead of repeating the run's first ones.
    batches = _make_batches(args, data_path, token_mode, args.seed + start)
    ckpt_writer, logger = _writers(args, gather)
    # a separately seeded held-out stream: eval never consumes (or overlaps
    # with) training batches
    eval_batches = (_make_batches(args, data_path, token_mode,
                                  args.seed + 7919)
                    if args.eval_every else None)
    # Fault injection for recovery drills (train/supervisor.py): crash at
    # step FFT_TPU_FAULT_STEP on fresh runs only (a transient failure: a
    # resumed run sails past it).
    fault_step = int(os.environ.get("FFT_TPU_FAULT_STEP", "0"))
    step_fn, eval_loss = train_step, lm_loss
    if mesh is not None or pp_mesh is not None:
        step_fn = functools.partial(train_step, mesh=mesh, pp_mesh=pp_mesh)
        eval_loss = functools.partial(lm_loss, mesh=mesh, pp_mesh=pp_mesh)
    with _draining(ckpt_writer, logger):
        _train_lm_loop(args, state, batches, eval_batches, ckpt_writer,
                       logger, start, fault_step, step_fn, eval_loss)
    _all_written()


@contextlib.contextmanager
def _draining(ckpt_writer, logger):
    """Close the logger and drain any in-flight checkpoint write, even when
    the loop raises: a crash must not lose the last checkpoint the
    supervisor resumes from.  A deferred write error must not replace a
    training exception already propagating (the real crash cause): it is
    logged."""
    try:
        yield
    finally:
        logger.close()
        if ckpt_writer is not None:
            in_flight_exc = sys.exc_info()[0] is not None
            try:
                ckpt_writer.wait()
            except Exception as ckpt_err:
                if not in_flight_exc:
                    raise
                print(f"async checkpoint write failed during crash "
                      f"handling: {ckpt_err!r}", file=sys.stderr)


def _final_save(args, state, ckpt_writer, start: int) -> None:
    """The last checkpoint, unless the loop just wrote it or the run
    resumed past its end (writing the restored state under a directory
    named args.steps would mislabel it)."""
    if (ckpt_writer is not None and start < args.steps
            and args.steps % args.ckpt_every != 0):
        ckpt_writer.save(state, args.steps)


def _train_lm_loop(args, state, batches, eval_batches, ckpt_writer, logger,
                   start: int, fault_step: int, step_fn, eval_loss) -> None:
    """The LM loops of train-lm and train-hybrid: ``step_fn(state,
    batch)`` a step, ``eval_loss(model, tokens)`` on the held-out stream
    every ``--eval-every`` steps, in eval mode; with ``--profile``, a
    trace of the run's third step (one step after warm-up)."""
    from fft_tpu_torch.parallel import is_primary
    from fft_tpu_torch.utils import profile_trace

    model = state.model
    device = model.tok_emb.device
    tokens_per_step = args.batch * args.seq
    for i, batch in zip(range(start, args.steps), batches):
        if fault_step and start == 0 and i + 1 == fault_step:
            raise RuntimeError(f"injected fault at step {i + 1}")
        if args.profile and i == start + 2 and is_primary():
            with profile_trace(args.profile, device):
                metrics = step_fn(state, batch)
        else:
            metrics = step_fn(state, batch)
        if i % args.log_every == 0 or i == args.steps - 1:
            rec = {"loss": metrics["loss"],
                   "grad_norm": metrics["grad_norm"]}
            if eval_batches is not None and i % args.eval_every == 0:
                mode = model.training
                model.eval()
                with torch.no_grad():
                    ce = float(eval_loss(model, torch.as_tensor(
                        next(eval_batches)).to(device, torch.int64)))
                model.train(mode)
                rec["eval_loss"] = ce
                rec["eval_ppl"] = float(np.exp(min(ce, 20.0)))
            logger.log(i, rec, tokens=tokens_per_step)
        if ckpt_writer is not None and (i + 1) % args.ckpt_every == 0:
            # the snapshot to host memory is synchronous; the disk write
            # overlaps the next training steps
            ckpt_writer.save(state, i + 1)
    _final_save(args, state, ckpt_writer, start)


def _resume(args, state, shard=None) -> int:
    """Restore the latest checkpoint under ``--ckpt`` into ``state`` with
    ``--resume`` (cut to this rank's shard by ``shard``); the step to start
    from."""
    from fft_tpu_torch.train.checkpoint import latest_step, restore_checkpoint
    if args.resume and args.ckpt and latest_step(args.ckpt) is not None:
        if shard is None:
            restore_checkpoint(args.ckpt, state)
        else:
            restore_checkpoint(args.ckpt, state, shard=shard)
        print(f"resumed at step {state.step}")
        return state.step
    return 0


def cmd_train_hybrid(args) -> None:
    """Train the hybrid SPECTRE + SWA LM (BASELINE config 5) on byte-level
    windows of ``--data`` (else the synthetic corpus).  ``--sp N`` runs
    context parallel (the SWA blocks' halo exchange, the SPECTRE blocks'
    sequence-parallel causal mix), ``--dp N`` data parallel."""
    import torch.distributed as dist
    from fft_tpu_torch.models.hybrid import (
        hybrid_1b_config, hybrid_init, hybrid_tiny_config)
    from fft_tpu_torch.parallel import make_mesh
    from fft_tpu_torch.train import (
        TrainConfig, hybrid_loss, hybrid_train_step, train_init)
    from fft_tpu_torch.train.data import CharDataset
    from fft_tpu_torch.utils import resolve_device

    device = resolve_device(args.device)
    make = hybrid_1b_config if args.preset == "1b" else hybrid_tiny_config
    cfg = make(seq=args.seq)
    if args.sp > 1:
        if (args.seq // args.sp) % cfg.attn_window:
            raise ValueError(f"the shard-local length {args.seq // args.sp} "
                             "must divide into SWA windows of "
                             f"{cfg.attn_window}")
        cfg = _segmented(cfg)
    if args.bf16:
        cfg = dataclasses.replace(cfg, block=dataclasses.replace(
            cfg.block, compute_dtype="bfloat16"))
    cp_mesh = (make_mesh(args.dp, args.sp, 1, device)
               if args.dp * args.sp > 1 or dist.is_initialized() else None)
    model = hybrid_init(cfg, torch.Generator().manual_seed(args.seed), device)
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps)
    state = train_init(model, tcfg, seed=args.seed + 1, deterministic=True)
    start = _resume(args, state)

    data = CharDataset(path=args.data)
    batches = data.batches(args.batch, args.seq, seed=args.seed + start)
    eval_batches = (data.batches(args.batch, args.seq, seed=args.seed + 7919)
                    if args.eval_every else None)
    # the hybrid's state is replicated on every rank: no gather
    ckpt_writer, logger = _writers(args, None)
    step_fn, eval_loss = hybrid_train_step, hybrid_loss
    if cp_mesh is not None:
        step_fn = functools.partial(hybrid_train_step, cp_mesh=cp_mesh)
        eval_loss = functools.partial(hybrid_loss, cp_mesh=cp_mesh)
    with _draining(ckpt_writer, logger):
        _train_lm_loop(args, state, batches, eval_batches, ckpt_writer,
                       logger, start, 0, step_fn, eval_loss)
    _all_written()


def cmd_train_vit(args) -> None:
    """Train the ViT (BASELINE config 3) on an image folder (``--data``)
    or synthetic class-conditional images."""
    from fft_tpu_torch.models.vit import ViTConfig, vit_init
    from fft_tpu_torch.train import train_init, vit_train_config, \
        vit_train_step
    from fft_tpu_torch.train.checkpoint import AsyncCheckpointWriter
    from fft_tpu_torch.train.images import (ImageFolderDataset,
                                            synthetic_image_batches)
    from fft_tpu_torch.utils import MetricsLogger, resolve_device

    device = resolve_device(args.device)
    dataset = None
    if args.data is not None:
        dataset = ImageFolderDataset(args.data)
        if args.classes != dataset.num_classes:
            print(f"--classes {args.classes} -> {dataset.num_classes} "
                  f"(from {args.data})")
            args.classes = dataset.num_classes
    cfg = ViTConfig(num_classes=args.classes, num_layers=args.layers)
    model = vit_init(cfg, torch.Generator().manual_seed(args.seed), device)
    state = train_init(model, vit_train_config(args.lr), seed=args.seed)
    start = _resume(args, state)

    # resumed runs continue the data stream from the restored step
    batches = (dataset.batches(args.batch, seed=args.seed + start)
               if dataset is not None
               else synthetic_image_batches(args.batch, cfg.image_size,
                                            args.classes,
                                            seed=args.seed + start))
    ckpt_writer = AsyncCheckpointWriter(args.ckpt) if args.ckpt else None
    logger = MetricsLogger(args.metrics, print_every=args.log_every)
    with _draining(ckpt_writer, logger):
        for i in range(start, args.steps):
            imgs, labels = next(batches)
            metrics = vit_train_step(state, imgs, labels)
            if i % args.log_every == 0:
                logger.log(i, {"loss": metrics["loss"]})
            if ckpt_writer is not None and (i + 1) % args.ckpt_every == 0:
                ckpt_writer.save(state, i + 1)
        _final_save(args, state, ckpt_writer, start)


def cmd_tokenize(args) -> None:
    """Train a byte-level BPE tokenizer on a text corpus and write the
    uint16 token stream and its vocab sidecar (train/bpe.py)."""
    from fft_tpu_torch.train.bpe import tokenize_file
    from fft_tpu_torch.train.data import synthetic_corpus

    text = (pathlib.Path(args.data).read_text(encoding="utf-8")
            if args.data else synthetic_corpus(args.chars))
    tok = tokenize_file(text, args.out, vocab_size=args.vocab_size,
                        max_merges=args.max_merges)
    n_tok = pathlib.Path(args.out).stat().st_size // 2
    print(json.dumps({
        "out": args.out, "vocab_size": tok.vocab_size,
        "merges_learned": len(tok.merges), "chars": len(text),
        "tokens": n_tok,
        "compression": round(len(text) / max(n_tok, 1), 3),
    }))


def cmd_generate(args) -> None:
    from fft_tpu_torch.models.lm import lm_generate, lm_init
    from fft_tpu_torch.utils import resolve_device

    device = resolve_device(args.device)
    cfg = _lm_config(args)
    model = lm_init(cfg, torch.Generator().manual_seed(args.seed), device)
    if args.ckpt:
        from fft_tpu_torch.train.checkpoint import restore_model
        restore_model(args.ckpt, model)
    tok = None
    if args.vocab:
        from fft_tpu_torch.train.bpe import Tokenizer, is_token_file, \
            vocab_sidecar
        path = (vocab_sidecar(args.vocab) if is_token_file(args.vocab)
                else args.vocab)
        tok = Tokenizer.load(path)
        _check_vocab(tok.vocab_size, cfg.vocab_size)
        prompt_ids = tok.encode(args.prompt).astype(np.int64)
    else:
        prompt_ids = np.frombuffer(args.prompt.encode("utf-8"),
                                   np.uint8).astype(np.int64)
    prompt = torch.from_numpy(prompt_ids)[None].to(device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    toks = lm_generate(model, prompt, steps=args.steps, generator=gen,
                       temperature=args.temperature)
    ids = toks[0].tolist()
    text = (tok.decode(ids) if tok is not None
            else bytes(int(t) % 256 for t in ids).decode(
                "utf-8", errors="replace"))
    print(args.prompt + text)


def cmd_bench_mix(args) -> None:
    """The JAX CLI's ``bench-mix`` (fft_tpu/cli.py:433-473): the bf16
    block's forward at each seq, timed as the slope between chains of 4
    and 16 forwards.  The reference's chain raises (its ``lax.scan``
    carries the fp32 input into a block that returns bf16); here x is cast
    to the block's compute dtype first, so every forward of the chain is
    the same."""
    from fft_tpu_torch.config import SpectreConfig
    from fft_tpu_torch.layers.common import DTYPES
    from fft_tpu_torch.layers.spectre import _mix_branch, spectre_block_init
    from fft_tpu_torch.utils import resolve_device
    from fft_tpu_torch.utils.prof import card, events_ms, spectral_mix_cost

    device = resolve_device(args.device)
    where = card(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for seq in (int(s) for s in args.seqs.split(",")):
        cfg = SpectreConfig(embed_dim=args.dim, num_heads=8, n_fft=seq,
                            pooling_type="mean", wavelet_on_rate=0.0,
                            compute_dtype="bfloat16")
        block = spectre_block_init(cfg, torch.Generator().manual_seed(0),
                                   device)
        x = torch.randn((args.batch, seq, args.dim),
                        generator=torch.Generator().manual_seed(1)).to(
                            device, DTYPES[cfg.compute_dtype])

        def chain(k):
            h = x
            for _ in range(k):
                h = block(h)
            return h

        def chain_ms(k) -> float:
            times = []
            for _ in range(3):
                if device.type == "cuda":
                    times.append(events_ms(lambda: chain(k), sync, 1))
                else:
                    t0 = time.perf_counter()
                    chain(k)
                    times.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(times)

        with torch.no_grad():
            chain(16)                       # plans and kernels built
            sync()
            ms = (chain_ms(16) - chain_ms(4)) / 12
        print(json.dumps({
            "seq": seq, "block_fwd_ms": ms,
            "tokens_per_sec": args.batch * seq / (ms / 1e3),
            "mix_roofline_ms": spectral_mix_cost(
                args.batch, seq, args.dim).roofline_ms(),
            "mix_branch": _mix_branch(cfg), **where}))


def main(argv=None):
    p = argparse.ArgumentParser(prog="fft_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    lm = sub.add_parser("train-lm")
    lm.add_argument("--preset", default="tiny", choices=["tiny", "350m"])
    lm.add_argument("--steps", type=int, default=1000)
    lm.add_argument("--batch", type=int, default=8)
    lm.add_argument("--seq", type=int, default=2048)
    lm.add_argument("--lr", type=float, default=3e-4)
    lm.add_argument("--data", default=None,
                    help="text corpus, or a .tokens BPE stream (with its "
                         ".vocab.json sidecar) from the tokenize command")
    lm.add_argument("--vocab-size", type=int, default=None,
                    help="override the preset's vocab size")
    lm.add_argument("--ckpt", default=None)
    lm.add_argument("--ckpt-every", type=int, default=500)
    lm.add_argument("--resume", action="store_true")
    lm.add_argument("--bf16", action="store_true")
    lm.add_argument("--metrics", default=None, help="JSONL metrics file")
    lm.add_argument("--log-every", type=int, default=10)
    lm.add_argument("--eval-every", type=int, default=0,
                    help="held-out loss/perplexity every N steps")
    lm.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of one step after "
                         "warm-up into DIR, with the program's spans "
                         "(fft_tpu_torch.train.forward, .backward, "
                         ".optimizer, .spectre.block, ...)")
    lm.add_argument("--dp", type=int, default=1, help="data parallel")
    lm.add_argument("--sp", type=int, default=1, help="sequence parallel")
    lm.add_argument("--tp", type=int, default=1,
                    help="tensor (head) parallel")
    lm.add_argument("--pp", type=int, default=1,
                    help="pipeline stages (alone: no --dp/--sp/--tp)")
    lm.add_argument("--seed", type=int, default=0)
    lm.add_argument("--device", default="cuda",
                    help="torch device: cuda (the default) or cpu")
    lm.set_defaults(fn=cmd_train_lm)

    hy = sub.add_parser("train-hybrid")
    hy.add_argument("--preset", default="tiny", choices=["tiny", "1b"])
    hy.add_argument("--steps", type=int, default=1000)
    hy.add_argument("--batch", type=int, default=1)
    hy.add_argument("--seq", type=int, default=2048)
    hy.add_argument("--lr", type=float, default=1e-4)
    hy.add_argument("--data", default=None, help="text corpus (byte-level)")
    hy.add_argument("--ckpt", default=None)
    hy.add_argument("--ckpt-every", type=int, default=500)
    hy.add_argument("--resume", action="store_true")
    hy.add_argument("--bf16", action="store_true")
    hy.add_argument("--metrics", default=None, help="JSONL metrics file")
    hy.add_argument("--log-every", type=int, default=10)
    hy.add_argument("--eval-every", type=int, default=0)
    hy.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of one step after "
                         "warm-up into DIR, with the program's spans "
                         "(fft_tpu_torch.train.forward, .backward, "
                         ".optimizer, .spectre.block, ...)")
    hy.add_argument("--dp", type=int, default=1, help="data parallel")
    hy.add_argument("--sp", type=int, default=1,
                    help="context parallel (SWA halo exchange + "
                         "sequence-parallel SPECTRE)")
    hy.add_argument("--seed", type=int, default=0)
    hy.add_argument("--device", default="cuda",
                    help="torch device: cuda (the default) or cpu")
    hy.set_defaults(fn=cmd_train_hybrid)

    vit = sub.add_parser("train-vit")
    vit.add_argument("--steps", type=int, default=100)
    vit.add_argument("--batch", type=int, default=32)
    vit.add_argument("--data", default=None,
                     help="ImageFolder root (class-per-subdir); default: "
                          "synthetic class-conditional images")
    vit.add_argument("--classes", type=int, default=1000)
    vit.add_argument("--layers", type=int, default=12)
    vit.add_argument("--lr", type=float, default=3e-4)
    vit.add_argument("--ckpt", default=None)
    vit.add_argument("--ckpt-every", type=int, default=100)
    vit.add_argument("--resume", action="store_true")
    vit.add_argument("--metrics", default=None, help="JSONL metrics file")
    vit.add_argument("--log-every", type=int, default=10)
    vit.add_argument("--seed", type=int, default=0)
    vit.add_argument("--device", default="cuda",
                     help="torch device: cuda (the default) or cpu")
    vit.set_defaults(fn=cmd_train_vit)

    tz = sub.add_parser("tokenize")
    tz.add_argument("--data", default=None,
                    help="UTF-8 text corpus (default: synthetic)")
    tz.add_argument("--out", required=True,
                    help="output token stream (.tokens)")
    tz.add_argument("--vocab-size", type=int, default=50432)
    tz.add_argument("--max-merges", type=int, default=None)
    tz.add_argument("--chars", type=int, default=2_000_000,
                    help="synthetic corpus size when no --data")
    tz.set_defaults(fn=cmd_tokenize)

    gen = sub.add_parser("generate")
    gen.add_argument("--preset", default="tiny", choices=["tiny", "350m"])
    gen.add_argument("--seq", type=int, default=2048)
    gen.add_argument("--bf16", action="store_true")
    gen.add_argument("--ckpt", default=None)
    gen.add_argument("--prompt", default="the ")
    gen.add_argument("--steps", type=int, default=64)
    gen.add_argument("--temperature", type=float, default=0.0)
    gen.add_argument("--vocab", default=None,
                     help="BPE vocab json (or .tokens file) for "
                          "encode/decode")
    gen.add_argument("--vocab-size", type=int, default=None)
    gen.add_argument("--seed", type=int, default=0)
    gen.add_argument("--device", default="cuda",
                     help="torch device: cuda (the default) or cpu")
    gen.set_defaults(fn=cmd_generate)

    bm = sub.add_parser("bench-mix")
    bm.add_argument("--seqs", default="1024,4096,16384")
    bm.add_argument("--batch", type=int, default=8)
    bm.add_argument("--dim", type=int, default=512)
    bm.add_argument("--device", default="cuda",
                    help="torch device: cuda (the default) or cpu")
    bm.set_defaults(fn=cmd_bench_mix)
    args = p.parse_args(argv)
    if args.cmd in ("train-lm", "train-hybrid"):
        # one process per card under torchrun (a no-op otherwise)
        from fft_tpu_torch.parallel import distributed_init
        distributed_init(device=args.device)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())

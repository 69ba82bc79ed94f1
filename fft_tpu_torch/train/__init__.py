"""Training (mirror of ``fft_tpu/train``): the optimizer, the LM loss and
the train step; char-level data."""

from fft_tpu_torch.train.loop import (
    AdamW, TrainConfig, TrainState, chunked_softmax_ce, lm_loss,
    make_optimizer, make_schedule, train_init, train_step,
)

__all__ = ["AdamW", "TrainConfig", "TrainState", "chunked_softmax_ce",
           "lm_loss", "make_optimizer", "make_schedule", "train_init",
           "train_step"]

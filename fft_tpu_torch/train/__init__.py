"""Training (mirror of ``fft_tpu/train``): the optimizer, the LM loss and
the train step (``loop``); char-level and BPE data (``data``, ``bpe``,
``native_loader``); checkpoints (``checkpoint``) and restarts
(``supervisor``)."""

from fft_tpu_torch.train.loop import (
    AdamW, TrainConfig, TrainState, chunked_softmax_ce, lm_loss,
    make_optimizer, make_schedule, train_init, train_step,
)

__all__ = ["AdamW", "TrainConfig", "TrainState", "chunked_softmax_ce",
           "lm_loss", "make_optimizer", "make_schedule", "train_init",
           "train_step"]

"""Training (mirror of ``fft_tpu/train``): the optimizer, the losses and
train steps of the LM, the hybrid LM and the ViT (``loop``); images
(``images``); char-level and BPE data (``data``, ``bpe``,
``native_loader``); checkpoints (``checkpoint``) and restarts
(``supervisor``)."""

from fft_tpu_torch.train.loop import (
    AdamW, TrainConfig, TrainState, chunked_softmax_ce, classification_loss,
    hybrid_loss, hybrid_train_step, lm_loss, make_optimizer, make_schedule,
    train_init, train_step, vit_train_config, vit_train_step,
)

__all__ = ["AdamW", "TrainConfig", "TrainState", "chunked_softmax_ce",
           "classification_loss", "hybrid_loss", "hybrid_train_step",
           "lm_loss", "make_optimizer", "make_schedule", "train_init",
           "train_step", "vit_train_config", "vit_train_step"]

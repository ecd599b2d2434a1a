"""Training (counterpart of the JAX package's ``train/``): the QAT loop."""

from .qat import (
    make_adamw,
    make_qat_train_step,
    restore_checkpoint,
    save_checkpoint,
    train_qat,
)

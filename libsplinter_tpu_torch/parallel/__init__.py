"""Training for the port: the encoder's contrastive step (train.py) and
trainer checkpoints (checkpoint.py), on one card."""
from .train import (TrainState, adamw, info_nce_loss, loss_fn,
                    make_train_step, state_from_jax)

__all__ = ["TrainState", "adamw", "info_nce_loss", "loss_fn",
           "make_train_step", "state_from_jax"]

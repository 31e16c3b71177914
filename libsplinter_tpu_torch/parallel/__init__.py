"""The port's parallel layer: the device mesh and its split rules
(mesh.py), the multi-process bootstrap (multihost.py), tensor- and
expert-parallel completion serving (serve.py), sharded similarity
search (sharded_search.py), and on one card the encoder's contrastive
training step (train.py) and trainer checkpoints (checkpoint.py)."""
from . import checkpoint
from .mesh import (Mesh, all_gather, all_reduce_sum, batch_sharding,
                   decoder_param_pspec, make_mesh, param_pspec,
                   param_shardings, replicated, shard_params,
                   shard_state_dict)
from .serve import (ShardedCompletionModel, ShardedDecoder,
                    shard_decoder_params)
from .sharded_search import PodSearch, shard_vectors, sharded_topk
from .train import (TrainState, adamw, info_nce_loss, loss_fn,
                    make_train_step, state_from_jax)

__all__ = ["checkpoint", "Mesh", "make_mesh", "batch_sharding",
           "replicated", "shard_params", "param_shardings", "param_pspec",
           "decoder_param_pspec", "shard_state_dict", "all_reduce_sum",
           "all_gather", "ShardedCompletionModel", "ShardedDecoder",
           "shard_decoder_params", "sharded_topk", "shard_vectors",
           "PodSearch", "TrainState", "adamw", "info_nce_loss", "loss_fn",
           "make_train_step", "state_from_jax"]

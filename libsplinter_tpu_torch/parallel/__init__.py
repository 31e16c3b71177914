"""The port's parallel layer: the device mesh and its split rules
(mesh.py), the multi-process bootstrap (multihost.py), tensor- and
expert-parallel completion serving (serve.py), sharded similarity
search (sharded_search.py), the encoder's contrastive training on one
card, sharded dp x tp and sequence-parallel dp x sp (train.py, ring
attention in ring_attention.py), the GPipe pipeline encoder
(pipeline.py) and trainer checkpoints (checkpoint.py)."""
from . import checkpoint
from .mesh import (Mesh, all_gather, all_reduce_sum, batch_sharding,
                   decoder_param_pspec, make_mesh, param_pspec,
                   param_shardings, replicated, shard_params,
                   shard_state_dict)
from .pipeline import (make_pipeline_encode_fn, pipeline_encode,
                       pipeline_encode_staged, stack_layer_params,
                       stage_params)
from .ring_attention import (dense_reference, ring_attention,
                             ring_attention_sharded)
from .serve import (ShardedCompletionModel, ShardedDecoder,
                    shard_decoder_params)
from .sharded_search import PodSearch, shard_vectors, sharded_topk
from .train import (ShardedEncoder, TrainState, adamw, info_nce_loss,
                    loss_fn, make_ring_train_step, make_sharded_train_step,
                    make_train_step, state_from_jax)

__all__ = ["checkpoint", "Mesh", "make_mesh", "batch_sharding",
           "replicated", "shard_params", "param_shardings", "param_pspec",
           "decoder_param_pspec", "shard_state_dict", "all_reduce_sum",
           "all_gather",
           "ShardedCompletionModel", "ShardedDecoder",
           "shard_decoder_params", "sharded_topk", "shard_vectors",
           "PodSearch", "TrainState", "adamw", "info_nce_loss", "loss_fn",
           "make_train_step", "state_from_jax", "make_sharded_train_step",
           "make_ring_train_step", "ShardedEncoder", "ring_attention",
           "ring_attention_sharded", "dense_reference", "pipeline_encode",
           "pipeline_encode_staged", "make_pipeline_encode_fn",
           "stack_layer_params", "stage_params"]

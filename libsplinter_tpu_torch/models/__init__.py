from .decoder import CompletionModel, DecoderConfig
from .encoder import EmbeddingModel, Encoder, EncoderConfig
from .gguf import (GgufFile, decoder_config_from_gguf,
                   encoder_config_from_gguf, load_decoder_params,
                   load_encoder_params, load_tokenizer)
from .tokenizer import (ByteTokenizer, HashTokenizer, WordPieceTokenizer,
                        batch_encode, default_tokenizer)
from .moe import MoeDecoder, MoeDecoderConfig, moe_completion_model
from .speculative import SpeculativeCompletionModel, self_draft_model

__all__ = ["Encoder", "EncoderConfig", "EmbeddingModel", "HashTokenizer",
           "WordPieceTokenizer", "ByteTokenizer", "batch_encode",
           "default_tokenizer", "DecoderConfig", "CompletionModel",
           "GgufFile", "decoder_config_from_gguf",
           "encoder_config_from_gguf", "load_decoder_params",
           "load_encoder_params", "load_tokenizer", "MoeDecoder",
           "MoeDecoderConfig", "moe_completion_model",
           "SpeculativeCompletionModel", "self_draft_model"]

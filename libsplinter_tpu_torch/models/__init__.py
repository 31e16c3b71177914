from .decoder import CompletionModel, DecoderConfig
from .encoder import EmbeddingModel, Encoder, EncoderConfig
from .tokenizer import (ByteTokenizer, HashTokenizer, WordPieceTokenizer,
                        batch_encode, default_tokenizer)

__all__ = ["Encoder", "EncoderConfig", "EmbeddingModel", "HashTokenizer",
           "WordPieceTokenizer", "ByteTokenizer", "batch_encode",
           "default_tokenizer", "DecoderConfig", "CompletionModel"]

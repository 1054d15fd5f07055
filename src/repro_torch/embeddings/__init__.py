from repro_torch.embeddings.cache import (CachingEmbedder, EmbeddingCache,
                                          content_key)
from repro_torch.embeddings.encoder import EmbeddingModel, encode_texts

__all__ = ["CachingEmbedder", "EmbeddingCache", "content_key",
           "EmbeddingModel", "encode_texts"]

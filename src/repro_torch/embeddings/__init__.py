from repro_torch.embeddings.cache import (CachingEmbedder, EmbeddingCache,
                                          content_key)

__all__ = ["CachingEmbedder", "EmbeddingCache", "content_key"]

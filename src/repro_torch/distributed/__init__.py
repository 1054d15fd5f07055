from repro_torch.distributed.round import shard_clusters

__all__ = ["shard_clusters"]

from repro_torch.distributed.coordinator import (CoordinatedLane,
                                                 DispatchCoordinator,
                                                 LaneStats)
from repro_torch.distributed.round import shard_clusters

__all__ = ["CoordinatedLane", "DispatchCoordinator", "LaneStats",
           "shard_clusters"]

from repro_torch.distributed.api import (current_rules, shard_act,
                                         sharding_context)
from repro_torch.distributed.coordinator import (CoordinatedLane,
                                                 DispatchCoordinator,
                                                 LaneStats)
from repro_torch.distributed.round import shard_clusters
from repro_torch.distributed.rules import (DEFAULT_LOGICAL_RULES, MeshRules,
                                           resolve_spec)

__all__ = ["CoordinatedLane", "DEFAULT_LOGICAL_RULES", "DispatchCoordinator",
           "LaneStats", "MeshRules", "current_rules", "resolve_spec",
           "shard_act", "shard_clusters", "sharding_context"]

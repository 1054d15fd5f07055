from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.batcher import BucketBatcher, DispatchMergeStats

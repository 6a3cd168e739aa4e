"""Giant-graph sampling tier: CSC neighbor sampling, geometry bucketing,
the hot-node feature cache and the assembled minibatch loader (DESIGN.md
§14), the reference's ``sampling`` package. Host code: numpy, and torch
only for the CPU ``BatchedCOO`` of each block.
"""
from repro_torch.sampling.bucketing import (  # noqa: F401
    block_caps,
    block_ladders,
    bucket_for,
)
from repro_torch.sampling.feature_cache import (  # noqa: F401
    FeatureStore,
    HotNodeCache,
    Prefetcher,
    static_hot_ids,
)
from repro_torch.sampling.item_sampler import ItemSampler  # noqa: F401
from repro_torch.sampling.loader import (  # noqa: F401
    SampledBatch,
    SampledNodeLoader,
)
from repro_torch.sampling.neighbor import (  # noqa: F401
    neighbor_sample,
    sample_layer,
)

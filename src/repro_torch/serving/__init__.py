"""Serving subsystem of the port: candidate index (flat and geohash-cell),
`ServingEngine`, online refresh, and the million-user tiled store and its
engine (mirrors `repro.serving`'s single-device exports)."""
from repro_torch.serving.candidates import (CandidateIndex, HierarchicalIndex,
                                            build_candidate_index, build_hierarchical_index,
                                            index_from_dataset)
from repro_torch.serving.engine import EngineStats, ServingConfig, ServingEngine
from repro_torch.serving.online import OnlineConfig, RefreshReport, online_refresh
from repro_torch.serving.store import (SyntheticFactors, TiledFactorStore, TiledServingEngine,
                                       store_from_numpy, synthetic_world)

__all__ = [
    "CandidateIndex", "EngineStats", "HierarchicalIndex", "OnlineConfig", "RefreshReport",
    "ServingConfig", "ServingEngine", "SyntheticFactors", "TiledFactorStore",
    "TiledServingEngine", "build_candidate_index", "build_hierarchical_index",
    "index_from_dataset", "online_refresh", "store_from_numpy", "synthetic_world",
]

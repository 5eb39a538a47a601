"""Serving subsystem of the port: candidate index, `ServingEngine`, online
refresh (mirrors `repro.serving`'s single-device exports)."""
from repro_torch.serving.candidates import (CandidateIndex, build_candidate_index,
                                            index_from_dataset)
from repro_torch.serving.engine import EngineStats, ServingConfig, ServingEngine
from repro_torch.serving.online import OnlineConfig, RefreshReport, online_refresh

__all__ = [
    "CandidateIndex", "EngineStats", "OnlineConfig", "RefreshReport", "ServingConfig",
    "ServingEngine", "build_candidate_index", "index_from_dataset", "online_refresh",
]

"""DMF on the Foursquare-like dataset — port of
`src/repro/configs/dmf_foursquare.py` (`GRAPH`, `dmf_config`), the paper's
primary benchmark (Table 1 row 1: 6,524 users / 3,197 POIs / 26,186
ratings / 117 cities). Hyperparameters follow the paper's §Experiments:
α=0.1, θ=0.1, N=2, m=3, w_{ii'}=1, K=10, D=3; β=0.1, γ=0.01.
"""
from repro_torch.core.dmf import DMFConfig
from repro_torch.core.graph import GraphConfig

GRAPH = GraphConfig(n_neighbors=2, walk_length=3, uniform_weights=True)


def dmf_config(n_users: int, n_items: int, dim: int = 10) -> DMFConfig:
    return DMFConfig(
        n_users=n_users, n_items=n_items, dim=dim,
        alpha=0.1, beta=0.1, gamma=0.01, lr=0.1, neg_samples=3,
    )

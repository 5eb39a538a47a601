"""DMF on the Alipay-like dataset — port of `src/repro/configs/dmf_alipay.py`
(Table 1 row 2: 5,996 users / 7,404 POIs / 18,978 ratings / 298 cities);
the Foursquare hyperparameters."""
from repro_torch.configs.dmf_foursquare import dmf_config  # noqa: F401 (same hypers)
from repro_torch.core.graph import GraphConfig

GRAPH = GraphConfig(n_neighbors=2, walk_length=3, uniform_weights=True)
DATASET = dict(kind="alipay", reduced_default=True)

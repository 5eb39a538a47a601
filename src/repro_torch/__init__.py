"""PyTorch + CUDA port of the DMF POI recommender (`src/repro`, JAX/Pallas).

The JAX package stays the reference; every module here names the reference
file and functions it ports. This package imports `torch` and numpy only —
never `jax`, never `repro`. Entry points take ``device`` (default
``"cuda"``) and raise when the card is missing (`repro_torch.device`).
"""

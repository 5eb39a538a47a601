"""Serving launcher: the prefill and decode steps — port of
`src/repro/launch/serve.py` (`make_prefill_step`, `make_decode_step`).
`serve_param_shardings` needs a mesh and belongs to the sharding slice.

Each maker resolves its device (cuda unless the caller asks for cpu; it
raises otherwise) and returns a callable that runs under
`torch.inference_mode()` and refuses a model on another device. The
reference donates the decode cache to its jitted step; here the step
writes into the cache tensors passed in and returns the same dict.

    step = make_prefill_step(cfg, device="cuda")
    logits, pcache = step(model, {"tokens": tokens})         # (B, 1, vocab)
    cache = cache_from_prefill(cfg, pcache, seq_len=S + n, device="cuda")
    decode = make_decode_step(cfg, device="cuda")
    logits, cache = decode(model, cache, next_tokens, S)     # position S
"""
from __future__ import annotations

import torch

from repro_torch import device as device_lib
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


def _require(model: transformer.Transformer, cfg: ModelConfig, dev: torch.device) -> None:
    if model.cfg != cfg:
        raise ValueError(f"the model is {model.cfg.name}'s, the step {cfg.name}'s")
    if model.device != dev:
        raise ValueError(f"the model lies on {model.device}, the step runs on {dev}")


def make_prefill_step(cfg: ModelConfig, device="cuda"):
    """``prefill_step(model, batch)`` → (last-position logits, cache);
    ``batch`` holds ``tokens`` and, for vision models, ``media``."""
    dev = device_lib.resolve(device)

    def prefill_step(model, batch):
        _require(model, cfg, dev)
        with torch.inference_mode():
            return transformer.prefill(model, batch["tokens"], media=batch.get("media"))

    return prefill_step


def make_decode_step(cfg: ModelConfig, device="cuda"):
    """``serve_step(model, cache, tokens, pos)`` → (logits, cache), the
    cache written in place."""
    dev = device_lib.resolve(device)

    def serve_step(model, cache, tokens, pos):
        _require(model, cfg, dev)
        with torch.inference_mode():
            return transformer.decode_step(model, cache, tokens, pos)

    return serve_step


def cache_from_prefill(cfg: ModelConfig, prefill_cache: dict, seq_len: int, device="cuda") -> dict:
    """A decode cache of ``seq_len`` positions holding a prefill's caches,
    spliced as the reference's `test_vlm_cross_cache_decode` does
    (`tests/test_models_smoke.py:118-129`): self-attention leaves at
    [:S], cross (``mk``, ``mv``) and SSM (``conv``, ``state``) leaves as
    they are. A sliding-window ring shorter than the prefill keeps its
    last ``buf`` positions, position t at slot t % buf."""
    dev = device_lib.resolve(device)
    batch = next(iter(next(iter(prefill_cache.values())).values())).shape[1]
    cache = transformer.init_cache(cfg, batch, seq_len, device=dev)
    for pos, leaves in prefill_cache.items():
        for name, v in leaves.items():
            buf = cache[pos][name]
            if name in ("mk", "mv", "conv", "state"):
                buf.copy_(v)
                continue
            S, n = v.shape[2], buf.shape[2]
            if S <= n:
                buf[:, :, :S] = v
            else:   # a ring: the last n positions, each at its slot
                slots = torch.arange(S - n, S, device=dev) % n
                buf[:, :, slots] = v[:, :, S - n:]
    return cache

"""Attention: GQA and MLA, prefill (blockwise online softmax) and one-token
decode — port of `src/repro/models/attention.py` (all of it):
`blockwise_attention` (:30-112), `triangular_attention` (:114-147),
`_dense_attend` (:150), `decode_attend` (:166-192), GQA (`init_gqa`,
`gqa_qkv`, `gqa_out`, :195-245), MLA (`init_mla`, `mla_compress`,
`mla_queries`, `mla_attend_full`, the absorbed `mla_decode`, :248-350) and
gated cross-attention (`init_cross_attn`, `cross_attend`, :353-368),
with the logical-axis specs each ``init_*`` returns (`gqa_specs`,
`mla_specs`, `cross_specs`). The sequence-sharded decode
(`decode_attend_partial`, `mla_decode_partial`, `merge_partials`) splits
`decode_attend` and `mla_decode` at their softmax, for a cache whose
positions lie over several ranks (`launch/serve.py` on a mesh).

The reference computes attention in `jnp` einsums with an online softmax
(no Pallas kernel); the port mirrors that schedule in plain PyTorch: the
same q×kv chunk loop carrying ``acc, m, l``, the same dense shortcut
condition, the same ``NEG_INF`` and the same ``softmax_scale or
1/sqrt(hd)`` rule, so that the numerics follow the reference's.
Parameters keep the reference's layouts (``wq`` (d, H, hd), ``wo``
(H, hd, d)) and are float32, cast to the compute dtype at each use.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Blockwise (flash-style) attention, O(S·chunk) memory.
# ---------------------------------------------------------------------------
def blockwise_attention(
    q: torch.Tensor,        # (B, Sq, H, hd)
    k: torch.Tensor,        # (B, Sk, KV, hd)
    v: torch.Tensor,        # (B, Sk, KV, vd)
    *,
    causal: bool = True,
    q_offset: int = 0,      # absolute position of q[0] (prefill continuation)
    q_chunk: int = 1024,
    kv_chunk: int = 2048,
    softmax_scale: float | None = None,
    triangular: bool = False,
    window: int = 0,        # >0: sliding-window (band) causal attention
) -> torch.Tensor:
    """Nested q×kv chunked attention with online softmax: the (Sq, Sk)
    score matrix is never materialized beyond a (q_chunk, kv_chunk) tile.
    Every kv chunk is scanned for every q chunk (masked tiles computed,
    then masked), as in the reference's baseline schedule."""
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    if (triangular and causal and not window and Sq == Sk and q_offset == 0
            and Sq % max(q_chunk, 1) == 0 and Sq > q_chunk):
        return triangular_attention(q, k, v, q_chunk=q_chunk, softmax_scale=softmax_scale)
    vd = v.shape[-1]
    G = H // KV
    scale = softmax_scale or 1.0 / math.sqrt(hd)
    qf = (q * scale).reshape(B, Sq, KV, G, hd).float()

    if Sk <= kv_chunk and Sq <= q_chunk:
        return _dense_attend(qf, k, v, causal, q_offset, window).reshape(B, Sq, H, vd).to(q.dtype)

    # pad Sq to a multiple of q_chunk (cross-attn with ragged Sq)
    pad_q = (-Sq) % q_chunk
    if pad_q:
        qf = torch.nn.functional.pad(qf, (0, 0, 0, 0, 0, 0, 0, pad_q))
    Sqp = qf.shape[1]
    nq = Sqp // q_chunk
    assert Sk % kv_chunk == 0, f"Sk={Sk} not divisible by kv_chunk={kv_chunk}"
    nk = Sk // kv_chunk
    dev = q.device
    out = torch.empty((B, Sqp, KV, G, vd), dtype=torch.float32, device=dev)
    for i in range(nq):
        qstart = i * q_chunk
        qb = qf[:, qstart:qstart + q_chunk]
        qpos = q_offset + qstart + torch.arange(q_chunk, device=dev)
        acc = torch.zeros((B, KV, G, q_chunk, vd), dtype=torch.float32, device=dev)
        m = torch.full((B, KV, G, q_chunk), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, KV, G, q_chunk), dtype=torch.float32, device=dev)
        for j in range(nk):
            kstart = j * kv_chunk
            kb = k[:, kstart:kstart + kv_chunk].float()
            vb = v[:, kstart:kstart + kv_chunk].float()
            s = torch.einsum("bqkgh,bskh->bkgqs", qb, kb)
            if causal:
                kvpos = kstart + torch.arange(kv_chunk, device=dev)
                mask = qpos[:, None] >= kvpos[None, :]
                if window:
                    mask &= (qpos[:, None] - kvpos[None, :]) < window
                s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bkgqs,bskv->bkgqv", p, vb)
            m = m_new
        o = acc / torch.clamp(l[..., None], min=1e-30)            # (B,KV,G,qc,vd)
        out[:, qstart:qstart + q_chunk] = o.permute(0, 3, 1, 2, 4)
    out = out.reshape(B, Sqp, H, vd)
    if pad_q:
        out = out[:, :Sq]
    return out.to(q.dtype)


def triangular_attention(
    q: torch.Tensor,        # (B, S, H, hd)   self-attention, Sq == Sk
    k: torch.Tensor,        # (B, S, KV, hd)
    v: torch.Tensor,        # (B, S, KV, vd)
    *,
    q_chunk: int = 2048,
    softmax_scale: float | None = None,
) -> torch.Tensor:
    """Causal attention over the lower triangle only: chunk i attends
    kv[: (i+1)·qc], each chunk a plain softmax."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    vd = v.shape[-1]
    G = H // KV
    scale = softmax_scale or 1.0 / math.sqrt(hd)
    qf = (q * scale).reshape(B, S, KV, G, hd).float()
    assert S % q_chunk == 0, (S, q_chunk)
    nq = S // q_chunk
    outs = []
    for i in range(nq):
        qb = qf[:, i * q_chunk:(i + 1) * q_chunk]
        end = (i + 1) * q_chunk
        kb, vb = k[:, :end], v[:, :end]
        s = torch.einsum("bqkgh,bskh->bkgqs", qb, kb.float())
        qpos = i * q_chunk + torch.arange(q_chunk, device=q.device)
        mask = qpos[:, None] >= torch.arange(end, device=q.device)[None, :]
        s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqs,bskv->bkgqv", p, vb.float())
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(B, q_chunk, H, vd))
    return torch.cat(outs, dim=1).to(q.dtype)


def _dense_attend(qf, k, v, causal, q_offset, window: int = 0):
    # qf: (B,Sq,KV,G,hd) pre-scaled f32
    B, Sq, KV, G, hd = qf.shape
    Sk = k.shape[1]
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, k.float())
    if causal:
        qpos = q_offset + torch.arange(Sq, device=qf.device)
        kpos = torch.arange(Sk, device=qf.device)
        mask = qpos[:, None] >= kpos[None, :]
        if window:
            mask &= (qpos[:, None] - kpos[None, :]) < window
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskv->bkgqv", p, v.float())
    return out.permute(0, 3, 1, 2, 4)  # (B,Sq,KV,G,vd)


def decode_attend(
    q: torch.Tensor,          # (B, H, hd) — single new token
    cache_k: torch.Tensor,    # (B, S, KV, hd)
    cache_v: torch.Tensor,    # (B, S, KV, vd)
    length: int,              # valid prefix length (== pos of new token + 1)
    softmax_scale: float | None = None,
    *,
    offset: int = 0,          # position of the cache's first entry
    merge=None,               # the sequence-sharded softmax's merge over ranks
) -> torch.Tensor:
    """One-token attention against a KV cache; entries at ``length`` and
    beyond are masked to ``NEG_INF`` (they contribute exp(NEG_INF) = 0).

    With ``merge`` the cache is one rank's slice of the positions, from
    ``offset``: the rank's partial softmax (its max, sum and weighted
    values, `softmax_partial`) goes to ``merge`` (`merge_partials` over
    the ranks holding the other slices), which returns the output."""
    B, S, KV, hd = cache_k.shape
    H = q.shape[1]
    G = H // KV
    scale = softmax_scale or 1.0 / math.sqrt(hd)
    qf = (q * scale).reshape(B, KV, G, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qf, cache_k.float())
    mask = offset + torch.arange(S, device=q.device) < length
    s = torch.where(mask, s, NEG_INF)
    if merge is None:
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bkgs,bskv->bkgv", p, cache_v.float())
    else:
        m, l, p = softmax_partial(s)
        out = merge(m, l, torch.einsum("bkgs,bskv->bkgv", p, cache_v.float()))
    return out.reshape(B, H, -1).to(q.dtype)


def softmax_partial(s: torch.Tensor):
    """A slice's share of a softmax over the last dim: (its max m, its sum
    l of exp(s - m), the weights exp(s - m))."""
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    return m, p.sum(dim=-1), p


def merge_partials(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The log-sum-exp merge of the slices' partial softmaxes over the mesh
    ``axes``: M = max of m; acc and l rescaled by exp(m - M), summed;
    acc / l. A slice with no valid entry has m = NEG_INF and weighs 0."""
    from repro_torch.sharding import spmd
    M = spmd.all_reduce(m, mesh, axes, op="max")
    c = torch.exp(m - M)
    num = spmd.all_reduce(acc * c[..., None], mesh, axes)
    den = spmd.all_reduce(l * c, mesh, axes)
    return num / den[..., None]


# ---------------------------------------------------------------------------
# GQA projections
# ---------------------------------------------------------------------------
class GQAAttention(nn.Module):
    """`init_gqa` (:195-222): ``wq`` (d, H, hd), ``wk``/``wv`` (d, KV, hd) at
    0.02, ``wo`` (H, hd, d) at 0.02/sqrt(2·n_layers); with ``qkv_bias``
    (Qwen1.5) zero biases ``bq`` (H, hd), ``bk``/``bv`` (KV, hd)."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__()
        d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        s, so = 0.02, 0.02 / math.sqrt(2 * cfg.n_layers)
        self.wq = layers.normal((d, H, hd), s, generator, device)
        self.wk = layers.normal((d, KV, hd), s, generator, device)
        self.wv = layers.normal((d, KV, hd), s, generator, device)
        self.wo = layers.normal((H, hd, d), so, generator, device)
        if cfg.qkv_bias:
            z = lambda *shape: nn.Parameter(torch.zeros(shape, dtype=torch.float32, device=device))
            self.bq, self.bk, self.bv = z(H, hd), z(KV, hd), z(KV, hd)


def gqa_specs(cfg: ModelConfig) -> dict:
    """The logical axes `init_gqa` returns beside its parameters (:207-221)."""
    specs = {"wq": ("embed", "heads", None), "wk": ("embed", "kv_heads", None),
             "wv": ("embed", "kv_heads", None), "wo": ("heads", None, "embed")}
    if cfg.qkv_bias:
        specs |= {"bq": ("heads", None), "bk": ("kv_heads", None), "bv": ("kv_heads", None)}
    return specs


def gqa_qkv(params: GQAAttention, x, positions, cfg: ModelConfig, dtype):
    q = torch.einsum("bsd,dhk->bshk", x, params.wq.to(dtype))
    k = torch.einsum("bsd,dhk->bshk", x, params.wk.to(dtype))
    v = torch.einsum("bsd,dhk->bshk", x, params.wv.to(dtype))
    if cfg.qkv_bias:
        q = q + params.bq.to(dtype)
        k = k + params.bk.to(dtype)
        v = v + params.bv.to(dtype)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_out(params, o, dtype):
    return torch.einsum("bshk,hkd->bsd", o, params.wo.to(dtype))


# ---------------------------------------------------------------------------
# MLA — Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3). The cache
# stores only the normed latent c_kv and the shared RoPE key; decode runs
# in the absorbed form (attention in latent space).
# ---------------------------------------------------------------------------
class MLAAttention(nn.Module):
    """`init_mla` (:248-286): queries ``wq`` (d or q_lora, H, hd) and
    ``wq_rope`` (d or q_lora, H, rd); ``w_dkv`` (d, r), ``w_kr`` (d, rd),
    ``kv_norm`` ones (r,), ``w_uk`` (r, H, hd), ``w_uv`` (r, H, vd), ``wo``
    (H, vd, d) at 0.02/sqrt(2·n_layers); with q-LoRA also ``w_dq``
    (d, q_lora) and ``q_norm`` ones."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__()
        d, H = cfg.d_model, cfg.n_heads
        r, rd = cfg.kv_lora_rank, cfg.rope_head_dim
        hd, vd = cfg.head_dim, cfg.v_head_dim
        s, so = 0.02, 0.02 / math.sqrt(2 * cfg.n_layers)
        dq = cfg.q_lora_rank or d
        self.wq = layers.normal((dq, H, hd), s, generator, device)
        self.wq_rope = layers.normal((dq, H, rd), s, generator, device)
        self.w_dkv = layers.normal((d, r), s, generator, device)
        self.w_kr = layers.normal((d, rd), s, generator, device)
        self.kv_norm = layers.init_rms_norm(r, device)
        self.w_uk = layers.normal((r, H, hd), s, generator, device)
        self.w_uv = layers.normal((r, H, vd), s, generator, device)
        self.wo = layers.normal((H, vd, d), so, generator, device)
        if cfg.q_lora_rank:
            self.w_dq = layers.normal((d, cfg.q_lora_rank), s, generator, device)
            self.q_norm = layers.init_rms_norm(cfg.q_lora_rank, device)


def mla_specs(cfg: ModelConfig) -> dict:
    """The logical axes `init_mla` returns (:268-285): with q-LoRA the
    queries' first dim is the LoRA rank, not sharded."""
    specs = {"wq": ("embed", "heads", None), "wq_rope": ("embed", "heads", None),
             "w_dkv": ("embed", None), "w_kr": ("embed", None), "kv_norm": (None,),
             "w_uk": (None, "heads", None), "w_uv": (None, "heads", None),
             "wo": ("heads", None, "embed")}
    if cfg.q_lora_rank:
        specs |= {"w_dq": ("embed", None), "q_norm": (None,),
                  "wq": (None, "heads", None), "wq_rope": (None, "heads", None)}
    return specs


def mla_compress(params: MLAAttention, x, positions, cfg: ModelConfig, dtype):
    """x -> (c_kv normed, k_rope): exactly what the MLA cache stores."""
    c_kv = torch.einsum("bsd,dr->bsr", x, params.w_dkv.to(dtype))
    c_kv = layers.rms_norm(c_kv, params.kv_norm, cfg.norm_eps)
    k_r = torch.einsum("bsd,dr->bsr", x, params.w_kr.to(dtype))
    k_r = layers.apply_rope(k_r[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_r


def mla_queries(params: MLAAttention, x, positions, cfg: ModelConfig, dtype):
    if cfg.q_lora_rank:
        xq = torch.einsum("bsd,dr->bsr", x, params.w_dq.to(dtype))
        xq = layers.rms_norm(xq, params.q_norm, cfg.norm_eps)
    else:
        xq = x
    q = torch.einsum("bsr,rhk->bshk", xq, params.wq.to(dtype))
    q_r = torch.einsum("bsr,rhk->bshk", xq, params.wq_rope.to(dtype))
    q_r = layers.apply_rope(q_r, positions, cfg.rope_theta)
    return q, q_r


def mla_attend_full(params: MLAAttention, x, positions, cfg: ModelConfig, dtype, kv_chunk: int):
    """Prefill MLA: keys and values expanded per head from the latent; the
    score scale is 1/sqrt(head_dim + rope_head_dim) (:318)."""
    q, q_r = mla_queries(params, x, positions, cfg, dtype)
    c_kv, k_r = mla_compress(params, x, positions, cfg, dtype)
    k = torch.einsum("bsr,rhk->bshk", c_kv, params.w_uk.to(dtype))
    v = torch.einsum("bsr,rhv->bshv", c_kv, params.w_uv.to(dtype))
    k_full = torch.cat([k, k_r[:, :, None, :].expand(q_r.shape)], -1)
    q_full = torch.cat([q, q_r], -1)
    scale = 1.0 / math.sqrt(cfg.head_dim + cfg.rope_head_dim)
    o = blockwise_attention(q_full, k_full, v, causal=True, kv_chunk=kv_chunk,
                            softmax_scale=scale, triangular=cfg.triangular_attention)
    out = torch.einsum("bshv,hvd->bsd", o, params.wo.to(dtype))
    return out, (c_kv, k_r)


def mla_decode(params: MLAAttention, x, cache_ckv, cache_kr, length: int, positions,
               cfg: ModelConfig, dtype, *, offset: int = 0, merge=None):
    """Absorbed-form single-token MLA decode against the latent cache:
    q_abs[h] = q[h] @ W_uk[h]^T; scores q_abs·c_kv + q_rope·k_rope, scaled by
    1/sqrt(head_dim + rope_head_dim) (:338); output (p·c_kv) @ W_uv.
    ``offset`` and ``merge``: a slice of the positions, as in `decode_attend`."""
    q, q_r = mla_queries(params, x, positions, cfg, dtype)   # (B,1,H,*)
    q, q_r = q[:, 0], q_r[:, 0]                              # (B,H,*)
    q_abs = torch.einsum("bhk,rhk->bhr", q, params.w_uk.to(dtype))
    scale = 1.0 / math.sqrt(cfg.head_dim + cfg.rope_head_dim)
    s = torch.einsum("bhr,bsr->bhs", q_abs.float(), cache_ckv.float())
    s = s + torch.einsum("bhk,bsk->bhs", q_r.float(), cache_kr.float())
    s = s * scale
    S = cache_ckv.shape[1]
    mask = offset + torch.arange(S, device=x.device) < length
    s = torch.where(mask, s, NEG_INF)
    if merge is None:
        p = torch.softmax(s, dim=-1)
        o_lat = torch.einsum("bhs,bsr->bhr", p, cache_ckv.float()).to(dtype)
    else:
        m, l, p = softmax_partial(s)
        o_lat = merge(m, l, torch.einsum("bhs,bsr->bhr", p, cache_ckv.float())).to(dtype)
    o = torch.einsum("bhr,rhv->bhv", o_lat, params.w_uv.to(dtype))
    return torch.einsum("bhv,hvd->bd", o, params.wo.to(dtype))[:, None, :]


# ---------------------------------------------------------------------------
# Cross-attention (Llama-3.2-Vision style image layers)
# ---------------------------------------------------------------------------
class CrossAttention(GQAAttention):
    """`init_cross_attn` (:353-357): GQA's projections and a tanh gate,
    zero-initialised (the layer starts as the identity)."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__(cfg, generator=generator, device=device)
        self.gate = nn.Parameter(torch.zeros((), dtype=torch.float32, device=device))


def cross_specs(cfg: ModelConfig) -> dict:
    """`init_cross_attn`'s logical axes (:353-357): GQA's and the scalar gate's ``()``."""
    return gqa_specs(cfg) | {"gate": ()}


def cross_attend(params: CrossAttention, x, media: torch.Tensor, cfg: ModelConfig, dtype):
    """x: (B,S,D) text; media: (B,M,D) precomputed patch embeddings (the
    stubbed frontend). No RoPE; no causal mask."""
    q = torch.einsum("bsd,dhk->bshk", x, params.wq.to(dtype))
    k = torch.einsum("bmd,dhk->bmhk", media, params.wk.to(dtype))
    v = torch.einsum("bmd,dhk->bmhk", media, params.wv.to(dtype))
    o = blockwise_attention(q, k, v, causal=False, kv_chunk=max(k.shape[1], 16))
    out = torch.einsum("bshk,hkd->bsd", o, params.wo.to(dtype))
    return torch.tanh(params.gate).to(dtype) * out

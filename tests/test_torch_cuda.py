"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips with a reason where no card is present
(the CPU tests hold the plain versions against the JAX reference instead).
On a machine with a card and without JAX, run them with

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest sets up JAX host devices). Values
agree within 1e-5; top-k indices may differ only where the plain version
scores the two items within 1e-5 (fp32 sums over K in another order). The
DP kernels: the noise stream's hash words exactly, its draws and the
clipped, noised messages within 1e-6 (one fp32 ulp of log/cos), the fused
DP step's deltas within 1e-5. The slab form of the serving kernel
(`serve_topk`) equals the window form on the windows gathered from the
same rows, and the int8/bf16 form (`serve_topk_window_quant`) equals it on
the dequantized windows, bit for bit, as does the same kernel reading the
tiled store in place (`serve_topk_tiled_quant`, rows aligned and at odd
offsets, shard views) against the form on the gathered windows, and the
slab form reading the serving state in place (`serve_topk_rows`, V or P
and Q, every layout; an id or bucket out of range traps) against kernel 1
on the gathered windows and the pre-gathered slab form; the noise
stream's words and draws equal those of the clip + noise kernel's path
(the same device function) bit for bit from one row to beyond a wave;
the tiled engine on the card agrees with the same store on the CPU (store tensors bit for bit, slates as
above). The per-user top-k (kernel 2) reading rows in place (``rows``, ``Q``)
and in every layout equals the call on the materialized rows bit for bit.
The shared-V top-k (`recommend_topk`, kernel 4) is held like the
other top-k kernels, and on one user with V = p^i + q^i equals the
per-user kernel bit for bit; the gradients kernel (`dmf_grads`, kernel 9)
is within 2e-5 abs + rel of its plain version (plus, across layouts,
the bound on two fp32 orders of the residual's dot), every layout equal
to the wrapper's bit for bit, its gp equals the fused step's bit for bit,
and −θ·gu, −θ·gq are the step's deltas within one ulp; the walk-mixing
product (`gossip_mix_op`, kernel 10) is within
1e-5 + 1e-5·(|M| @ |X|) of the fp32 product, bf16 inputs upcast; its
sparse and dense routes give the same bits for finite X, and non-finite X
gives the plain product's NaN pattern. The fused steps (kernels 3, 7) give
the same bits twice in a row at every batch size, one block or several,
and the port's accumulating scatters give the same bits on two runs.
The robustness slice on the card: the trivial churn plan with an inactive
defense gives plain `fit`'s bits (DP off and on), a resumed churn + DP +
screened run gives the uninterrupted run's bits on the card, an attacked,
defended, churned DP run agrees with the same run on the CPU (losses 1e-4
relative, factors 1e-5 absolute), and `robust_combine` on the card agrees
with the CPU (median bit for bit, trim within 1e-6 relative). Observability
and scheduling on the card: a DP `fit` with telemetry gives the bits of
the same fit without it, the scheduler's slates equal a direct `recommend`
bit for bit, and a profiled scheduler run's trace holds a kernel event for
every dispatch. The LM training half on the card (none of the port's
kernels launches): one AdamW ``allreduce`` step of each `ARCH_IDS` config
at `reduced()` in fp32 agrees with the same step on the CPU (loss,
gradients, updated parameters within 1e-4 × the CPU leaf's largest
magnitude; AdamW with eps=1e-3, see `tests/test_torch_lm_training.py`);
remat on and off give the same loss and gradients bit for bit in bf16;
the in-place AdamW equals the functional form bit for bit; the gossip
step meets `test_gossip_training_converges_small_lm`'s assertions.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref, serve_topk, topk_scores
from repro_torch.serving.store import int8_rows

pytestmark = pytest.mark.cuda
TOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU tests cover the plain versions")
    return torch.device("cuda")


def _hold(got, plain, scores):
    gv, gi = (x.cpu().numpy() for x in got)
    pv, pi = (x.cpu().numpy() for x in plain)
    np.testing.assert_array_equal(gi < 0, pi < 0)
    np.testing.assert_allclose(gv, pv, rtol=0, atol=TOL)
    for r, s in np.argwhere(gi != pi):
        assert abs(scores(r, gi[r, s]) - pv[r, s]) <= TOL


@pytest.mark.parametrize("R,Cw,k", [(64, 384, 10), (5, 128, 16), (3, 1000, 1)])
def test_serve_topk_window_kernel(dev, R, Cw, k):
    rng = np.random.default_rng(R)
    K = 10
    U = rng.normal(size=(R, K)).astype(np.float32)
    U[0] = 0.0
    Vw = rng.normal(size=(R, Cw, K)).astype(np.float32)
    Vw[1, ::2] = Vw[1, 1]
    cand = np.full((R, Cw), -1, np.int32)
    for r in range(R):
        n = int(rng.integers(0, Cw + 1)) if r else Cw
        cand[r, :n] = np.sort(rng.choice(5000, n, replace=False))
    seen = (rng.random((R, Cw)) < 0.1).astype(np.int8)
    U, Vw, cand, seen = (torch.as_tensor(x, device=dev) for x in (U, Vw, cand, seen))
    before = ops.serve_topk_window.launches
    got = ops.serve_topk_window(U, Vw, cand, seen, k)
    torch.cuda.synchronize()
    assert ops.serve_topk_window.launches == before + 1
    sc = (U[:, None] * Vw).sum(-1).masked_fill((cand < 0) | (seen != 0), ref.NEG_INF).cpu().numpy()
    ids = cand.cpu().numpy()
    _hold(got, ref.serve_topk_window_ref(U, Vw, cand, seen, k),
          lambda r, item: sc[r, np.flatnonzero(ids[r] == item)[0]])


@pytest.mark.parametrize("R,J,k", [(64, 3197, 10), (7, 129, 16), (2, 5, 10)])
def test_topk_peruser_kernel(dev, R, J, k):
    rng = np.random.default_rng(J)
    K = 10
    U = rng.normal(size=(R, K)).astype(np.float32)
    V = rng.normal(size=(R, J, K)).astype(np.float32)
    V[0, J // 2:] = 0.0
    mask = (rng.random((R, J)) < 0.2).astype(np.int8)
    mask[-1] = 1
    U, V, mask = (torch.as_tensor(x, device=dev) for x in (U, V, mask))
    before = ops.recommend_topk_peruser.launches
    got = ops.recommend_topk_peruser(U, V, mask, k)
    torch.cuda.synchronize()
    assert ops.recommend_topk_peruser.launches == before + 1
    sc = (U[:, None] * V).sum(-1).masked_fill(mask != 0, ref.NEG_INF).cpu().numpy()
    _hold(got, ref.topk_scores_peruser_ref(U, V, mask, k), lambda r, item: sc[r, item])


@pytest.mark.parametrize("B", [256, 1000, 1])
def test_dmf_fused_step_kernel(dev, B):
    rng = np.random.default_rng(B)
    x = [rng.normal(0, 0.5, (B, 10)).astype(np.float32) for _ in range(3)]
    r = (rng.random(B) < 0.25).astype(np.float32)
    x += [r, np.where(r > 0, 1.0, 1 / 3).astype(np.float32)]
    x = [torch.as_tensor(a, device=dev) for a in x]
    hp = dict(theta=0.1, alpha=0.1, beta=0.1, gamma=0.01)
    before = ops.dmf_fused_step.launches
    got = ops.dmf_fused_step(*x, **hp)
    torch.cuda.synchronize()
    assert ops.dmf_fused_step.launches == before + 1
    plain = ref.dmf_fused_step_ref(*x, *hp.values())
    for a, b in zip(got[:3], plain[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=TOL)
    torch.testing.assert_close(got[3], plain[3], rtol=TOL, atol=0)
    again = ops.dmf_fused_step(*x, **hp)[3]     # fixed-order reduction: same bits
    assert torch.equal(again, got[3])


DRAW_TOL = 1e-6


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_gauss_counter_kernel(dev, seed):
    from repro_torch.kernels import dp_noise
    rid = np.concatenate([np.arange(30_000), np.arange((1 << 23) - 64, (1 << 23) + 64)])
    rid = torch.as_tensor(rid.astype(np.int32), device=dev)
    for got, plain in zip(dp_noise.counter_words(seed, rid, 10),
                          dp_noise.counter_words_ref(seed, rid, 10)):
        assert torch.equal(got, plain)                    # hash words exact
    before = ops.gauss_counter.launches
    draws = ops.gauss_counter(seed, rid, 10)
    torch.cuda.synchronize()
    assert ops.gauss_counter.launches == before + 1
    torch.testing.assert_close(draws, dp_noise.gauss_counter_ref(seed, rid, 10),
                               rtol=0, atol=DRAW_TOL)


@pytest.mark.parametrize("N", [1, 33, 28_160, 300_000])
@pytest.mark.parametrize("n_cols", [1, 8, 10, 16, 256])
def test_gauss_counter_stream_kernel_over_waves(dev, N, n_cols):
    """The stream kernel (two columns of one row a thread for even n_cols,
    blocks of whole rows; at 300,000 rows, and 28,160 at 256 columns,
    more blocks than one wave of the SMs holds): hash words equal to
    the plain version's word for word, draws equal bit for bit to those of
    the clip + noise kernel (one thread an element through the same device
    function) on zero messages with noise 1, and within 1e-6 of the plain
    version. Rids from below 2^23 to beyond, and 2^31 - 1."""
    from repro_torch.kernels import dp_noise
    rid = ((1 << 23) - N // 2 + np.arange(N)).astype(np.int32)
    rid[-1] = 2**31 - 1
    rid = torch.as_tensor(rid, device=dev)
    for seed in (0, 7, 2**31 - 1):
        for got, plain in zip(dp_noise.counter_words(seed, rid, n_cols),
                              dp_noise.counter_words_ref(seed, rid, n_cols)):
            assert torch.equal(got, plain)
        before = ops.gauss_counter.launches
        draws = ops.gauss_counter(seed, rid, n_cols)
        torch.cuda.synchronize()
        assert ops.gauss_counter.launches == before + 1
        zeros = torch.zeros((N, n_cols), device=dev)
        msgs = ops.dp_clip_noise(zeros, rid, seed, clip=float("inf"), noise_std=1.0)
        assert torch.equal((draws + 0.0).view(torch.int32), msgs.view(torch.int32))
        torch.testing.assert_close(draws, dp_noise.gauss_counter_ref(seed, rid, n_cols),
                                   rtol=0, atol=DRAW_TOL)


@pytest.mark.parametrize("B", [256, 100, 1])
@pytest.mark.parametrize("clip,std", [(float("inf"), 0.0), (0.5, 0.0), (0.5, 0.7), (1e-3, 1.0)])
def test_dp_clip_noise_kernel(dev, B, clip, std):
    rng = np.random.default_rng(B)
    g = rng.normal(size=(B, 10)).astype(np.float32)
    g[0] = 0.0
    rid = ((1 << 23) - B // 2 + np.arange(B)).astype(np.int32)
    g, rid = (torch.as_tensor(x, device=dev) for x in (g, rid))
    before = ops.dp_clip_noise.launches
    got = ops.dp_clip_noise(g, rid, 11, clip=clip, noise_std=std)
    torch.cuda.synchronize()
    assert ops.dp_clip_noise.launches == before + 1
    torch.testing.assert_close(got, ref.dp_clip_noise_ref(g, rid, 11, clip, std),
                               rtol=0, atol=DRAW_TOL)
    if clip == float("inf") and std == 0.0:
        assert torch.equal(got, g)                        # disabled: bit for bit


@pytest.mark.parametrize("B", [25, 26, 1000, 5000])
@pytest.mark.parametrize("K", [8, 10, 16, 256])
def test_dp_clip_noise_kernel_across_blocks_with_nan_and_zero_rows(dev, B, K):
    """One thread an element over several blocks (256 / K whole rows a
    block): against the plain version with a zero row (scale 1) and a NaN
    row (NaN everywhere in it, as the reference's minimum keeps it), and
    the disabled mechanism g bit for bit on every finite row."""
    rng = np.random.default_rng(B + K)
    g = rng.normal(size=(B, K)).astype(np.float32)
    g[0] = 0.0
    g[B // 2, K // 2] = np.nan
    rid = ((1 << 23) - B // 2 + np.arange(B)).astype(np.int32)
    g, rid = (torch.as_tensor(x, device=dev) for x in (g, rid))
    for clip, std in ((0.5, 0.0), (0.5, 0.7), (float("inf"), 1.0)):
        got = ops.dp_clip_noise(g, rid, 3, clip=clip, noise_std=std)
        want = ref.dp_clip_noise_ref(g, rid, 3, clip, std)
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert bool(torch.isnan(got[B // 2]).all())
        fin = ~torch.isnan(want)
        torch.testing.assert_close(got[fin], want[fin], rtol=0, atol=DRAW_TOL)
    off = ops.dp_clip_noise(g, rid, 3, clip=float("inf"), noise_std=0.0)
    finite = torch.ones(B, dtype=torch.bool, device=dev)
    finite[B // 2] = False
    assert torch.equal(off[finite].view(torch.int32), g[finite].view(torch.int32))
    assert bool(torch.isnan(off[B // 2]).all())


@pytest.mark.parametrize("B", [256, 100, 1])
@pytest.mark.parametrize("clip", [float("inf"), 0.5, 1e-3])
def test_dmf_fused_step_dp_kernel(dev, B, clip):
    rng = np.random.default_rng(B)
    x = [rng.normal(0, 0.5, (B, 10)).astype(np.float32) for _ in range(3)]
    x[0][0] = x[1][0] = 0.0                               # a zero-norm message row
    r = (rng.random(B) < 0.25).astype(np.float32)
    x += [r, np.where(r > 0, 1.0, 1 / 3).astype(np.float32),
          (0.5 * rng.normal(size=(B, 10))).astype(np.float32)]
    x = [torch.as_tensor(a, device=dev) for a in x]
    hp = dict(theta=0.1, alpha=0.1, beta=0.1, gamma=0.01)
    before = ops.dmf_fused_step_dp.launches
    got = ops.dmf_fused_step_dp(*x, **hp, clip=clip)
    torch.cuda.synchronize()
    assert ops.dmf_fused_step_dp.launches == before + 1
    plain = ref.dmf_fused_step_dp_ref(*x, *hp.values(), clip)
    for a, b in zip(got[:3], plain[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=TOL)
    torch.testing.assert_close(got[3], plain[3], rtol=TOL, atol=0)
    # kernel 3 on the same rows: the same deltas and loss, bit for bit
    k3 = ops.dmf_fused_step(*x[:5], **hp)
    for i in (0, 2, 3):
        assert torch.equal(got[i], k3[i])


def _slab_case(rng, R, J, Cw, K, dev):
    """Whole slabs with exact ties, -1 padding, an all-seen row and a row
    with fewer candidates than k; plus the windows gathered from them."""
    U = rng.normal(size=(R, K)).astype(np.float32)
    U[0] = 0.0
    V = rng.normal(size=(R, J, K)).astype(np.float32)
    V[1, ::2] = V[1, 1]
    cand = np.full((R, Cw), -1, np.int32)
    for r in range(R):
        n = {0: Cw, 2: 3}.get(r, int(rng.integers(0, Cw + 1)))
        cand[r, :n] = np.sort(rng.choice(J, n, replace=False))
    seen = (rng.random((R, J)) < 0.1).astype(np.int8)
    seen[min(3, R - 1)] = 1
    U, V, cand, seen = (torch.as_tensor(x, device=dev) for x in (U, V, cand, seen))
    safe = cand.clamp_min(0).long()
    rows = torch.arange(R, device=dev)[:, None]
    return U, V, cand, seen, V[rows, safe].contiguous(), seen[rows, safe].contiguous()


@pytest.mark.parametrize("R,J,Cw,k", [(64, 3197, 384, 10), (5, 129, 128, 16), (4, 40, 17, 1)])
def test_serve_topk_and_quant_kernels(dev, R, J, Cw, k):
    rng = np.random.default_rng(J)
    U, V, cand, seen, Vw, seen_w = _slab_case(rng, R, J, Cw, 8, dev)
    Vw[R - 1] = 0.0                                       # an all-zero int8 user
    slab_cand = cand.clone()
    slab_cand[0, -1] = J + 5                              # past the slab: no candidate
    sc = (U[:, None] * V).sum(-1)
    elig = torch.zeros_like(seen, dtype=torch.bool)
    live = (cand >= 0) & (slab_cand < J)
    elig[torch.nonzero(live, as_tuple=True)[0], cand[live].long()] = True
    sc = sc.masked_fill(~elig | (seen != 0), ref.NEG_INF).cpu().numpy()
    before = ops.serve_topk.launches
    got = ops.serve_topk(U, V, slab_cand, seen, k)
    torch.cuda.synchronize()
    assert ops.serve_topk.launches == before + 1
    _hold(got, ref.serve_topk_ref(U, V, slab_cand, seen, k), lambda r, item: sc[r, item])
    assert not (got[1] == J + 5).any()
    codes, scale = int8_rows(Vw)
    assert scale[R - 1] == np.float32(1e-12)
    ids = cand.cpu().numpy()
    for q, s in ((codes, scale), (Vw.to(torch.bfloat16), torch.ones(R, device=dev))):
        deq = q.float() * s[:, None, None]
        wsc = (U[:, None] * deq).sum(-1).masked_fill((cand < 0) | (seen_w != 0), ref.NEG_INF)
        wsc = wsc.cpu().numpy()
        before = ops.serve_topk_window_quant.launches
        got = ops.serve_topk_window_quant(U, q, s, cand, seen_w, k)
        torch.cuda.synchronize()
        assert ops.serve_topk_window_quant.launches == before + 1
        _hold(got, ref.serve_topk_window_quant_ref(U, q, s, cand, seen_w, k),
              lambda r, item: wsc[r, np.flatnonzero(ids[r] == item)[0]])


@pytest.mark.parametrize("R,J,Cw,k", [(64, 3197, 384, 10), (128, 1000, 128, 10), (3, 50, 20, 16)])
def test_slab_and_quant_kernels_equal_the_window_kernel_bitwise(dev, R, J, Cw, k):
    rng = np.random.default_rng(R + J)
    U, V, cand, seen, Vw, seen_w = _slab_case(rng, R, J, Cw, 8, dev)
    window = ops.serve_topk_window(U, Vw, cand, seen_w, k)
    for a, b in zip(ops.serve_topk(U, V, cand, seen, k), window):
        assert torch.equal(a, b)
    codes, scale = int8_rows(Vw)
    bf16 = Vw.to(torch.bfloat16)
    ones = torch.ones(R, device=dev)
    for q, s in ((codes, scale), (bf16, ones)):
        deq = (q.float() * s[:, None, None]).contiguous()
        for a, b in zip(ops.serve_topk_window_quant(U, q, s, cand, seen_w, k),
                        ops.serve_topk_window(U, deq, cand, seen_w, k)):
            assert torch.equal(a, b)


def _store_case(rng, I, R, cap, K, dev, offset):
    """A tiled store's resident tensors (7 buckets of ascending ids, one
    all padding, one full; an all-seen user, a zero user, an all-zero int8
    user) with its codes and bf16 factors starting ``offset`` elements into
    their storage (rows off 16, 8, 4 or 2 bytes), and R user ids with
    repeats."""
    n_buckets = 7
    fill = [cap, 0, *rng.integers(0, cap + 1, n_buckets - 2)]
    bucket_items = np.full((n_buckets, cap), -1, np.int32)
    for b, n in enumerate(fill):
        bucket_items[b, :n] = np.sort(rng.choice(5000, n, replace=False))
    user_bucket = rng.integers(0, n_buckets, I).astype(np.int64)
    U = rng.normal(size=(I, K)).astype(np.float32)
    U[1] = 0.0
    V = rng.normal(size=(I, cap, K)).astype(np.float32)
    V[2] = 0.0
    V[3, ::2] = V[3, -1]
    seen = (rng.random((I, cap)) < 0.1).astype(np.int8)
    seen[4] = 1
    ids = rng.integers(0, I, R).astype(np.int64)
    ids[: min(R, 5)] = np.arange(min(R, 5))
    if R > 6:
        ids[6] = ids[5]
    U, V, seen, bucket_items, user_bucket, ids = (
        torch.as_tensor(x, device=dev) for x in (U, V, seen, bucket_items, user_bucket, ids))
    codes, scale = int8_rows(V)

    def shifted(x):
        buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=dev)
        out = buf[offset:].view(x.shape)
        out.copy_(x)
        return out
    return (U, shifted(codes), scale, shifted(V.to(torch.bfloat16)), seen, user_bucket,
            bucket_items, ids)


@pytest.mark.parametrize("R", [1, 37, 128, 300])
@pytest.mark.parametrize("Cw", [1, 37, 128, 300])
@pytest.mark.parametrize("K", [8, 10, 16])
def test_tiled_quant_kernel_equals_its_plain_version_and_the_gathered_kernel(dev, R, Cw, K):
    """Kernel 6 reading the store in place: against its plain version, and
    bit for bit against the pre-gathered kernel 6 on the gathered windows
    (rows at the same offset) and kernel 1 on the dequantized windows;
    int8 and bf16, k 1/10/16, rows aligned and at odd offsets."""
    rng = np.random.default_rng(R * 1000 + Cw + K)
    I = max(R, 60)
    for offset in (0, 1, 3):
        U, codes, scale, bf16, seen, ub, bi, ids = _store_case(rng, I, R, Cw, K, dev, offset)
        for Vq, sc in ((codes, scale), (bf16, None)):
            scale_r = torch.ones(R, device=dev) if sc is None else sc[ids]
            win = torch.empty(Vq.numel() // I * R + offset, dtype=Vq.dtype, device=dev)
            win = win[offset:].view(R, Cw, K)
            win.copy_(Vq[ids])
            cand, sw, u = bi[ub[ids]], seen[ids], U[ids]
            deq = (win.float() * scale_r[:, None, None]).contiguous()
            wsc = (u[:, None] * deq).sum(-1).masked_fill((cand < 0) | (sw != 0), ref.NEG_INF)
            wsc, cids = wsc.cpu().numpy(), cand.cpu().numpy()
            for k in (1, 10, 16):
                before = ops.serve_topk_tiled_quant.launches
                got = ops.serve_topk_tiled_quant(ids, U, Vq, sc, ub, bi, seen, k)
                torch.cuda.synchronize()
                assert ops.serve_topk_tiled_quant.launches == before + 1
                _hold(got, ref.serve_topk_tiled_quant_ref(ids, U, Vq, sc, ub, bi, seen, k),
                      lambda r, item: wsc[r, np.flatnonzero(cids[r] == item)[0]])
                gathered = ops.serve_topk_window_quant(u, win, scale_r, cand, sw, k)
                for a, b in zip(got, gathered):
                    assert torch.equal(a, b)
                for a, b in zip(gathered, ops.serve_topk_window(u, deq, cand, sw, k)):
                    assert torch.equal(a, b)


def test_tiled_quant_kernel_on_shard_views_and_layouts(dev):
    """In place on a shard's row views (user ids rebased, codes at an
    offset into the whole store) and in other launch layouts: the same
    slates as the whole store's, bit for bit."""
    rng = np.random.default_rng(5)
    I, R, cap, K = 900, 128, 128, 8
    U, codes, scale, bf16, seen, ub, bi, ids = _store_case(rng, I, R, cap, K, dev, 0)
    start = 301
    local = ids[(ids >= start) & (ids < 600)] - start
    for Vq, sc in ((codes, scale), (bf16, None)):
        whole = ops.serve_topk_tiled_quant(local + start, U, Vq, sc, ub, bi, seen, 10)
        part = ops.serve_topk_tiled_quant(local, U[start:600], Vq[start:600],
                                          None if sc is None else sc[start:600], ub[start:600],
                                          bi, seen[start:600], 10)
        for a, b in zip(part, whole):
            assert torch.equal(a, b)
        for warps, rpb in ((1, 1), (1, 8), (2, 1), (4, 1)):
            lay = dict(warps=warps, rpb=rpb,
                       slots=serve_topk.slots_for(10, -(-cap // (32 * warps))))
            got = serve_topk.tiled_quant_on_layout(local + start, U, Vq, sc, ub, bi, seen, 10, lay)
            for a, b in zip(got, whole):
                assert torch.equal(a, b)


def test_tiled_engine_quant_modes_launch_one_in_place_kernel(dev):
    """The engine's int8 and bf16 dispatches: one launch of the in-place
    kernel a microbatch, no launch of the pre-gathered one."""
    from repro_torch.serving import (ServingConfig, SyntheticFactors, TiledFactorStore,
                                     TiledServingEngine, build_hierarchical_index,
                                     synthetic_world)
    uc, ic, ucoord, icoord = synthetic_world(3000, 600, 6, seed=1)
    hier = build_hierarchical_index(ic, uc, icoord, ucoord, cell_cap=64)
    sf = SyntheticFactors.create(3000, 600, 8, seed=2)
    store = TiledFactorStore.synthetic(sf, hier.flat, seen_per_user=2, seed=3, device=dev)
    ids = np.random.default_rng(4).integers(0, 3000, 300)
    for mode in ("int8", "bf16"):
        eng = TiledServingEngine(store, ServingConfig(microbatch=64), mode=mode)
        before = (ops.serve_topk_tiled_quant.launches, ops.serve_topk_window_quant.launches)
        eng.recommend(ids)
        assert ops.serve_topk_tiled_quant.launches == before[0] + eng.stats.n_dispatches == \
            before[0] + 5
        assert ops.serve_topk_window_quant.launches == before[1]


def test_tiled_engine_on_the_card_equals_the_cpu(dev):
    from repro_torch.serving import (ServingConfig, SyntheticFactors, TiledFactorStore,
                                     TiledServingEngine, build_hierarchical_index,
                                     synthetic_world)
    uc, ic, ucoord, icoord = synthetic_world(3000, 600, 6, seed=1)
    hier = build_hierarchical_index(ic, uc, icoord, ucoord, cell_cap=64)
    sf = SyntheticFactors.create(3000, 600, 8, seed=2)
    card = TiledFactorStore.synthetic(sf, hier.flat, seen_per_user=2, seed=3, device=dev)
    host = TiledFactorStore.synthetic(sf, hier.flat, seen_per_user=2, seed=3, device="cpu")
    assert torch.equal(card.slab.cpu(), host.slab)          # two eager ops, no FMA
    assert torch.equal(card.seen.cpu(), host.seen)
    ids = np.concatenate([np.random.default_rng(4).integers(0, 3000, 500), [-1, 3000]])
    for mode in ("fp32", "int8", "bf16"):
        cfg = ServingConfig(microbatch=64)
        c_eng = TiledServingEngine(card, cfg, mode=mode)
        h_eng = TiledServingEngine(host, cfg, mode=mode)
        if mode == "int8":
            assert torch.equal(card.q_codes.cpu(), host.q_codes)
            assert torch.equal(card.q_scale.cpu(), host.q_scale)
        if mode == "bf16":
            assert torch.equal(card.slab_bf16.cpu().view(torch.int16),
                               host.slab_bf16.view(torch.int16))
        cv, ci, cf = c_eng.recommend(ids, return_flags=True)
        hv, hi, hf = h_eng.recommend(ids, return_flags=True)
        np.testing.assert_array_equal(cf, hf)
        np.testing.assert_array_equal(ci[cf], hi[hf])
        np.testing.assert_allclose(cv, hv, rtol=0, atol=TOL)
        win = (host.slab if mode == "fp32" else host.slab_bf16.float() if mode == "bf16"
               else host.q_codes.float() * host.q_scale[:, None, None])
        for r, s in np.argwhere(ci != hi):          # only exact or 1e-5 ties may swap
            u = int(ids[r])
            cand = hier.flat.bucket_items[hier.flat.user_bucket[u]]
            pos = int(np.flatnonzero(cand == ci[r, s])[0])
            assert abs(float((host.U[u] * win[u, pos]).sum()) - hv[r, s]) <= TOL


def _rows_state(rng, I, R, J, Cw, K, dev, offset):
    """The serving engine's resident state for kernel 5 in place: U (I, K)
    with an all-zero user (3); V and Q (I, J, K) starting ``offset``
    elements into their storage (0, 1, 2: rows aligned, 4 or 8 bytes off),
    with repeated
    rows (user 5); seen (I, J) with an all-seen user (2); 7 buckets of
    ascending ids (0 full, 1 padding only, 2 three ids, user 4's, unseen);
    R user ids, unsorted, with repeats."""
    n_buckets = 7
    bucket_items = np.full((n_buckets, Cw), -1, np.int32)
    for b in range(n_buckets):
        n = (Cw, 0, min(3, Cw))[b] if b < 3 else int(rng.integers(0, Cw + 1))
        bucket_items[b, :n] = np.sort(rng.choice(J, n, replace=False))
    user_bucket = rng.integers(0, n_buckets, I).astype(np.int64)
    user_bucket[:5] = (0, 1, 0, 0, 2)
    U = rng.normal(size=(I, K)).astype(np.float32)
    U[3] = 0.0
    V, Q = (rng.normal(size=(I, J, K)).astype(np.float32) for _ in range(2))
    V[5, ::2], Q[5, ::2] = V[5, -1], Q[5, -1]
    seen = (rng.random((I, J)) < 0.1).astype(np.int8)
    seen[2] = 1
    seen[4, bucket_items[2, :3]] = 0
    ids = rng.integers(0, I, R).astype(np.int64)
    ids[: min(R, 6)] = (4, 0, 1, 2, 3, 5)[: min(R, 6)]
    if R > 7:
        ids[7] = ids[6]

    def shifted(x):
        buf = torch.empty(x.size + offset, dtype=torch.float32, device=dev)
        out = buf[offset:].view(x.shape)
        out.copy_(torch.as_tensor(x, device=dev))
        return out
    U, seen, bucket_items, user_bucket, ids = (
        torch.as_tensor(x, device=dev) for x in (U, seen, bucket_items, user_bucket, ids))
    return ids, U, shifted(V), shifted(Q), seen, user_bucket, bucket_items


def _rows_gathered(ids, U, V, Q, seen, user_bucket, bucket_items):
    """The pruned dispatch's gathers before kernel 5 read the state in
    place: (u, V windows, P + Q windows, cand, seen windows)."""
    cand = bucket_items[user_bucket[ids]]
    safe = cand.clamp_min(0).long()
    rows = ids[:, None]
    return U[ids], V[rows, safe], V[rows, safe] + Q[rows, safe], cand, seen[rows, safe]


@pytest.mark.parametrize("R", [1, 37, 64, 300])
@pytest.mark.parametrize("Cw", [1, 37, 384, 1000])
@pytest.mark.parametrize("K", [8, 10, 16])
def test_serve_topk_rows_kernel_equals_its_plain_version_and_the_gathered_kernels(dev, R, Cw,
                                                                                  K):
    """Kernel 5 reading the serving state in place, with and without Q:
    against its plain version, and bit for bit against kernel 1 on the
    gathered windows (of V, resp. of P + Q) and the pre-gathered slab form
    on the requests' slabs; k 1/10/16, rows aligned and at odd offsets."""
    rng = np.random.default_rng(R * 1000 + Cw + K)
    I, J = max(R, 60), Cw + 53
    for offset in (0, 1, 2):
        ids, U, V, Q, seen, ub, bi = _rows_state(rng, I, R, J, Cw, K, dev, offset)
        u, vw, pqw, cand, sw = _rows_gathered(ids, U, V, Q, seen, ub, bi)
        cids = cand.cpu().numpy()
        for q, win, slab in ((None, vw, V[ids]), (Q, pqw, (V + Q)[ids])):
            wsc = (u[:, None] * win).sum(-1).masked_fill((cand < 0) | (sw != 0), ref.NEG_INF)
            wsc = wsc.cpu().numpy()
            for k in (1, 10, 16):
                before = ops.serve_topk_rows.launches
                got = ops.serve_topk_rows(ids, U, V, seen, ub, bi, k, Q=q)
                torch.cuda.synchronize()
                assert ops.serve_topk_rows.launches == before + 1
                _hold(got, ref.serve_topk_rows_ref(ids, U, V, seen, ub, bi, k, Q=q),
                      lambda r, item: wsc[r, np.flatnonzero(cids[r] == item)[0]])
                for want in (ops.serve_topk_window(u, win.contiguous(), cand, sw.contiguous(), k),
                             ops.serve_topk(u, slab.contiguous(), cand, seen[ids], k)):
                    for a, b in zip(got, want):
                        assert torch.equal(a, b)


def test_serve_topk_rows_kernel_edge_requests_and_layouts(dev):
    """The held edge cases at the serving shape (R=64, Cw=384, K=10): a
    bucket of padding only and an all-seen user serve no item, an all-zero
    user the lowest unseen ids, three candidates under k fill three slots,
    an id past J is no candidate; every launch layout equals the
    wrapper's, bit for bit."""
    rng = np.random.default_rng(11)
    ids, U, V, Q, seen, ub, bi = _rows_state(rng, 200, 64, 3197, 384, 10, dev, 0)
    bi[0, -1] = 3197 + 9                   # the full bucket's largest id, past J
    for q in (None, Q):
        vals, idx = ops.serve_topk_rows(ids, U, V, seen, ub, bi, 16, Q=q)
        assert (idx[2] == -1).all() and (idx[3] == -1).all()          # users 1 and 2
        assert int((idx[0] >= 0).sum()) == 3 and (idx[0, 3:] == -1).all()
        live = [c for c in bi[0].tolist() if 0 <= c < 3197 and not seen[3, c]]
        assert idx[4].tolist() == live[:16] and bool((vals[4] == 0).all())
        assert not (idx == 3197 + 9).any()
        for warps, rpb in ((1, 1), (1, 4), (2, 2), (4, 1), (16, 1)):
            lay = dict(warps=warps, rpb=rpb,
                       slots=serve_topk.slots_for(16, max(1, -(-384 // (32 * warps)))))
            other = serve_topk.rows_on_layout(ids, U, V, seen, ub, bi, 16, lay, Q=q)
            assert torch.equal(other[0], vals) and torch.equal(other[1], idx), lay
    torch.cuda.synchronize()


@pytest.mark.parametrize("case", ["id", "negative id", "bucket"])
def test_serve_topk_rows_kernel_traps_on_an_id_or_bucket_out_of_range(dev, case):
    """An id outside [0, I), or a user's bucket outside [0, n_buckets),
    traps the kernel (in a child process: a trap ends the CUDA context)."""
    import os
    import pathlib
    import subprocess
    import sys
    code = f"""
import torch
from repro_torch.kernels import ops
dev = torch.device("cuda")
I, J, K, Cw = 20, 50, 10, 24
ids = torch.arange(8, device=dev)
ub = torch.zeros(I, dtype=torch.int64, device=dev)
bi = torch.arange(Cw, dtype=torch.int32, device=dev)[None]
case = {case!r}
if case == "id":
    ids[3] = I
elif case == "negative id":
    ids[3] = -1
else:
    ub[5] = 1
try:
    ops.serve_topk_rows(ids, torch.zeros(I, K, device=dev), torch.zeros(I, J, K, device=dev),
                        torch.zeros(I, J, dtype=torch.int8, device=dev), ub, bi, 10)
    torch.cuda.synchronize()
except RuntimeError as e:
    print("trapped:", e)
"""
    repo = pathlib.Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(repo / "src")}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env, cwd=str(repo))
    assert "trapped:" in res.stdout, (res.stdout, res.stderr)


def test_serving_engine_pruned_dispatches_launch_one_in_place_kernel(dev):
    """`recommend` (on V) and `serve_microbatch` (on P and Q) pruned: one
    launch of kernel 5 in place a microbatch, none of kernel 1, and the
    slates of kernel 1 on the gathered windows, bit for bit."""
    from repro_torch.core import dmf
    from repro_torch.data import synthetic_poi
    from repro_torch.serving import ServingConfig, ServingEngine, index_from_dataset
    ds = synthetic_poi.foursquare_like(reduced=True)
    cfg = dmf.DMFConfig(n_users=ds.n_users, n_items=ds.n_items)
    eng = ServingEngine(dmf.init_state(cfg, device=dev), index_from_dataset(ds),
                        ServingConfig(microbatch=64, k=10), train=ds.train, device=dev)
    ids = np.random.default_rng(3).integers(0, ds.n_users, 300)
    before = (ops.serve_topk_rows.launches, ops.serve_topk_window.launches)
    vals, idx, flags = eng.recommend(ids, return_flags=True)
    assert ops.serve_topk_rows.launches == before[0] + eng.stats.n_dispatches == before[0] + 5
    mv, mi, _ = eng.serve_microbatch(ids[:64])
    assert ops.serve_topk_rows.launches == before[0] + 6
    assert ops.serve_topk_window.launches == before[1]
    keep = np.flatnonzero(~flags)
    uids = torch.as_tensor(ids[keep], device=dev)
    u, vw, _, cand, sw = _rows_gathered(uids, eng.state.U, eng.V, eng.state.Q, eng.seen,
                                        eng._user_bucket, eng._bucket_items)
    wv, wi = ops.serve_topk_window(u, vw.contiguous(), cand, sw.contiguous(), 10)
    np.testing.assert_array_equal(vals[keep], wv.cpu().numpy())
    np.testing.assert_array_equal(idx[keep], wi.cpu().numpy())
    np.testing.assert_array_equal(mv, vals[:64])
    np.testing.assert_array_equal(mi, idx[:64])


@pytest.mark.parametrize("R,J,K,k", [(128, 256, 8, 5), (150, 500, 12, 10), (64, 1000, 15, 16),
                                     (256, 256, 5, 1), (6, 3197, 10, 10)])
def test_recommend_topk_kernel(dev, R, J, K, k):
    rng = np.random.default_rng(R + J + k)
    U = rng.normal(size=(R, K)).astype(np.float32)
    U[0] = 0.0                                            # all-zero scores: id ties
    V = rng.normal(size=(J, K)).astype(np.float32)
    V[J // 2:J // 2 + 20] = V[1]                          # repeated item rows
    mask = rng.random((R, J)) < 0.1
    mask[0] = False
    mask[-1] = True
    U, V, mask = (torch.as_tensor(x, device=dev) for x in (U, V, mask))
    before = ops.recommend_topk.launches
    got = ops.recommend_topk(U, V, mask, k)
    torch.cuda.synchronize()
    assert ops.recommend_topk.launches == before + 1
    sc = (U[:, None] * V[None]).sum(-1).masked_fill(mask, ref.NEG_INF).cpu().numpy()
    _hold(got, ref.topk_scores_ref(U, V, mask, k), lambda r, item: sc[r, item])
    assert (got[1][-1] == -1).all()
    assert got[1][0].tolist() == list(range(k))           # zero user: lowest ids


def test_recommend_topk_one_user_equals_the_peruser_kernel(dev):
    rng = np.random.default_rng(9)
    U = torch.as_tensor(rng.normal(size=(8, 10)).astype(np.float32), device=dev)
    V = torch.as_tensor(rng.normal(size=(8, 3197, 10)).astype(np.float32), device=dev)
    seen = torch.as_tensor(rng.random((8, 3197)) < 0.01, device=dev)
    for u in range(8):
        one = ops.recommend_topk(U[u][None], V[u], seen[u][None], 10)
        per = ops.recommend_topk_peruser(U[u][None], V[u][None], seen[u][None], 10)
        assert torch.equal(one[0], per[0]) and torch.equal(one[1], per[1])
        # the many-users layout too: the same chain per (user, item)
        many = topk_scores.shared_on_layout(U[u][None], V[u], seen[u][None], 10,
                                            topk_scores.shared_layout(1, 3197, 10, 10, n_sms=1))
        assert torch.equal(many[0], per[0]) and torch.equal(many[1], per[1])


def _rows_case(rng, N, J, K, dev):
    """Kernel 2's row sources: U, P, Q over N rows with an all-zero user,
    a row whose v = p + q is 0 on every third item, repeated items, an
    all-masked row and a row with three unmasked items."""
    U = rng.normal(size=(N, K)).astype(np.float32)
    U[0] = 0.0
    P = rng.normal(size=(N, J, K)).astype(np.float32)
    Q = rng.normal(size=(N, J, K)).astype(np.float32)
    P[1, ::3] = -Q[1, ::3]
    P[2, J // 2:J // 2 + 20] = P[2, 0]
    Q[2, J // 2:J // 2 + 20] = Q[2, 0]
    mask = (rng.random((N, J)) < 0.1).astype(np.int8)
    mask[0] = 0
    mask[3] = 1
    if N > 4:
        mask[4] = 1
        mask[4, rng.choice(J, min(J, 3), replace=False)] = 0
    return tuple(torch.as_tensor(x, device=dev) for x in (U, P, Q, mask))


@pytest.mark.parametrize("R", [1, 7, 64, 131, 133, 1024])
@pytest.mark.parametrize("J", [1, 33, 127, 128, 129, 3197])
@pytest.mark.parametrize("k", [1, 10, 16])
def test_topk_peruser_kernel_across_layouts_and_row_sources(dev, R, J, k):
    """Kernel 2 on materialized rows against its plain version; through
    rows (repeated, unsorted, odd, so 8 bytes off a 16-byte boundary at
    K=10) of V and of P and Q, and on slices of P and Q
    at an odd start; and every layout (clusters 1/2/4, warps, ring stages,
    V or P and Q) equal to the call on the materialized rows bit for bit."""
    K = 10
    rng = np.random.default_rng(R * J + k)
    N = R + 5
    U, P, Q, mask = _rows_case(rng, N, J, K, dev)
    rows = torch.as_tensor(rng.permutation(N)[:R], device=dev)
    if R > 4:
        rows[1], rows[2], rows[3], rows[4] = rows[0], 1, 3, 0
    Ur = U[:R].contiguous()
    Vm, Mm = (P[rows] + Q[rows]).contiguous(), mask[rows].contiguous()
    before = ops.recommend_topk_peruser.launches
    want = ops.recommend_topk_peruser(Ur, Vm, Mm, k)
    torch.cuda.synchronize()
    assert ops.recommend_topk_peruser.launches == before + 1
    sc = (Ur[:, None] * Vm).sum(-1).masked_fill(Mm != 0, ref.NEG_INF).cpu().numpy()
    _hold(want, ref.topk_scores_peruser_ref(Ur, Vm, Mm, k), lambda r, item: sc[r, item])
    V = (P + Q).contiguous()
    calls = [ops.recommend_topk_peruser(Ur, V, mask, k, rows=rows),
             ops.recommend_topk_peruser(Ur, P, mask, k, Q=Q, rows=rows)]
    for cluster in (1, 2, 4):
        for warps in {1, 4, 16 // cluster}:
            for stages in (1, 2):
                for fused in (False, True):
                    lay = topk_scores.rows_layout(J, K, k, cluster, warps, stages, fused, R)
                    calls.append(topk_scores.peruser_on_layout(
                        Ur, P, mask, k, lay, Q=Q, rows=rows) if fused else
                        topk_scores.peruser_on_layout(Ur, Vm, Mm, k, lay))
    for got in calls:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    s = 1                                  # odd start: rows 8 bytes off 16 at K=10
    sl = ops.recommend_topk_peruser(U[s:s + R], P[s:s + R], mask[s:s + R], k, Q=Q[s:s + R])
    plain = ops.recommend_topk_peruser(U[s:s + R].contiguous(), V[s:s + R].contiguous(),
                                       mask[s:s + R].contiguous(), k)
    assert torch.equal(sl[0], plain[0]) and torch.equal(sl[1], plain[1])
    torch.cuda.synchronize()


def test_topk_peruser_signed_zero_scores_tie_on_id(dev):
    """Scores of −0.0 and +0.0 rank equal in kernel 2 too: each slate is the
    lowest unmasked ids, in the few- and many-users layouts."""
    R, J, K = 140, 500, 10
    rng = np.random.default_rng(4)
    U = torch.full((R, K), 1e-30, device=dev)
    sign = np.where(rng.random((R, J, 1)) < 0.5, -1.0, 1.0).astype(np.float32)
    V = torch.as_tensor(np.broadcast_to(sign * 1e-30, (R, J, K)).copy(), device=dev)
    mask = torch.as_tensor(rng.random((R, J)) < 0.2, device=dev)
    for lay in (topk_scores.peruser_layout(R, J, K, 10, n_sms=10**9),
                topk_scores.peruser_layout(R, J, K, 10, n_sms=1)):
        vals, idx = topk_scores.peruser_on_layout(U, V, mask, 10, lay)
        for r, m in enumerate(mask.cpu().numpy()):
            assert idx[r].tolist() == np.flatnonzero(~m)[:10].tolist(), (lay, r)
        assert bool((vals == 0).all()) and bool(torch.signbit(vals).any())


def _shared_case(rng, R, J, K, dev):
    """Kernel 4's inputs with an all-zero user, repeated item rows, an
    all-masked row, and a row with fewer unmasked items than 16."""
    U = rng.normal(size=(R, K)).astype(np.float32)
    U[0] = 0.0
    V = rng.normal(size=(J, K)).astype(np.float32)
    V[J // 2:J // 2 + 20] = V[0]
    mask = rng.random((R, J)) < 0.1
    mask[0] = False
    if R > 1:
        mask[1] = True
    if R > 2:
        mask[2] = True
        mask[2, rng.choice(J, min(J, 3), replace=False)] = False
    return tuple(torch.as_tensor(x, device=dev) for x in (U, V, mask))


# J=6,000 at K=10 passes one shared-memory stage (5,604 items beside the merge scratch)
@pytest.mark.parametrize("R", [1, 2, 7, 133, 1100])
@pytest.mark.parametrize("J", [1, 31, 3197, 6000])
@pytest.mark.parametrize("k", [1, 10, 16])
def test_recommend_topk_kernel_across_layouts(dev, R, J, k):
    """The wrapper's layout against the plain version, and every layout
    (few users, many users in one J tile and in 1,000-item tiles) against
    each other bit for bit."""
    K = 10
    U, V, mask = _shared_case(np.random.default_rng(R * J + k), R, J, K, dev)
    before = ops.recommend_topk.launches
    got = ops.recommend_topk(U, V, mask, k)
    torch.cuda.synchronize()
    assert ops.recommend_topk.launches == before + 1
    sc = (U[:, None] * V[None]).sum(-1).masked_fill(mask, ref.NEG_INF).cpu().numpy()
    _hold(got, ref.topk_scores_ref(U, V, mask, k), lambda r, item: sc[r, item])
    assert got[1][0, :min(k, J)].tolist() == list(range(min(k, J)))   # zero user
    if R > 1:
        assert (got[1][1] == -1).all() and (got[0][1] == ref.NEG_INF).all()
    few = topk_scores.shared_layout(R, J, K, k, n_sms=10**9)
    many = topk_scores.shared_layout(R, J, K, k, n_sms=1)
    tiled = dict(many, tile=min(many["tile"], 1000))
    for layout in (few, many, tiled):
        other = topk_scores.shared_on_layout(U, V, mask, k, layout)
        assert torch.equal(other[0], got[0]) and torch.equal(other[1], got[1]), layout
    torch.cuda.synchronize()


def test_recommend_topk_signed_zero_scores_tie_on_id(dev):
    """Scores of −0.0 and +0.0 (products below the smallest subnormal)
    rank equal: each slate is the lowest unmasked ids, in both layouts."""
    J, K = 500, 10
    rng = np.random.default_rng(3)
    U = np.full((140, K), 1e-30, np.float32)
    V = (np.where(rng.random((J, K)) < 0.5, -1.0, 1.0) * 1e-30).astype(np.float32)
    V[:, 1:] = V[:, :1]                      # a row is all −1e-30 or all +1e-30
    mask = rng.random((140, J)) < 0.2
    U, V, mask = (torch.as_tensor(x, device=dev) for x in (U, V, mask))
    for layout in (topk_scores.shared_layout(140, J, K, 10, n_sms=10**9),
                   topk_scores.shared_layout(140, J, K, 10, n_sms=1)):
        vals, idx = topk_scores.shared_on_layout(U, V, mask, 10, layout)
        for r, m in enumerate(mask.cpu().numpy()):
            assert idx[r].tolist() == np.flatnonzero(~m)[:10].tolist(), (layout, r)
        # the chain rounds a negative product below the subnormals to −0.0
        assert bool((vals == 0).all()) and bool(torch.signbit(vals).any())
        assert bool((~torch.signbit(vals)).any())


@pytest.mark.parametrize("Cw", [1, 33, 128, 384, 1000])
@pytest.mark.parametrize("k", [1, 10, 16])
def test_serve_topk_window_kernel_layouts(dev, Cw, k):
    """Kernel 1 against its plain version at R=1 and R=37 (one warp and
    several a request, ragged Cw, k above the live candidates), and every
    layout against the wrapper's bit for bit."""
    rng = np.random.default_rng(Cw + k)
    for R in (1, 37):
        U = rng.normal(size=(R, 10)).astype(np.float32)
        Vw = rng.normal(size=(R, Cw, 10)).astype(np.float32)
        Vw[:, ::3] = Vw[:, :1]
        cand = np.full((R, Cw), -1, np.int32)
        for r in range(R):
            n = Cw if r == 0 else min(Cw, int(rng.integers(0, 12)))
            cand[r, :n] = np.sort(rng.choice(5000, n, replace=False))
        seen = (rng.random((R, Cw)) < 0.1).astype(np.int8)
        U, Vw, cand, seen = (torch.as_tensor(x, device=dev) for x in (U, Vw, cand, seen))
        got = ops.serve_topk_window(U, Vw, cand, seen, k)
        sc = (U[:, None] * Vw).sum(-1).masked_fill((cand < 0) | (seen != 0), ref.NEG_INF)
        sc, ids = sc.cpu().numpy(), cand.cpu().numpy()
        _hold(got, ref.serve_topk_window_ref(U, Vw, cand, seen, k),
              lambda r, item: sc[r, np.flatnonzero(ids[r] == item)[0]])
        for warps, rpb in ((1, 1), (1, 4), (2, 2), (4, 1), (16, 1)):
            per_lane = max(1, -(-Cw // (32 * warps)))
            layout = dict(warps=warps, rpb=rpb, slots=serve_topk.slots_for(k, per_lane))
            other = serve_topk.window_on_layout(U, Vw, cand, seen, k, layout)
            assert torch.equal(other[0], got[0]) and torch.equal(other[1], got[1]), layout
    torch.cuda.synchronize()


@pytest.mark.parametrize("case", ["block", "slots", "smem", "lists", "cluster"])
def test_top_k_kernels_refuse_layouts_they_cannot_run(dev, case):
    U = torch.zeros(4, 10, device=dev)
    Vw = torch.zeros(4, 384, 10, device=dev)
    cand = torch.zeros(4, 384, dtype=torch.int32, device=dev)
    seen = torch.zeros(4, 384, dtype=torch.int8, device=dev)
    V, mask = Vw[0], seen.bool()
    with pytest.raises(RuntimeError):
        if case == "block":          # 32 warps × 1 request: past the kernel's 512 threads
            serve_topk.window_on_layout(U, Vw, cand, seen, 10, dict(warps=32, rpb=1, slots=4))
        elif case == "slots":        # 12 candidates a lane need 16 slots for k=10
            serve_topk.window_on_layout(U, Vw, cand, seen, 10, dict(warps=1, rpb=1, slots=8))
        elif case == "smem":         # a J tile past 227 KB of shared memory
            layout = topk_scores.shared_layout(4, 384, 10, 10, n_sms=1)
            topk_scores.shared_on_layout(U, V, mask, 10, dict(layout, tile=6000))
        elif case == "lists":        # 4 blocks × 8 warps: more lists than one merge takes
            layout = topk_scores.rows_layout(384, 10, 10, 4, 8, 2, False, 4)
            topk_scores.peruser_on_layout(U, Vw, seen, 10, layout)
        else:                        # a cluster of 5 blocks
            layout = topk_scores.rows_layout(384, 10, 10, 5, 2, 2, False, 4)
            topk_scores.peruser_on_layout(U, Vw, seen, 10, layout)


def _grads_inputs(rng, B, K, dev):
    x = [rng.normal(size=(B, K)).astype(np.float32) for _ in range(3)]
    x += [rng.random(B).astype(np.float32) for _ in range(2)]
    return [torch.as_tensor(a, device=dev) for a in x]


@pytest.mark.parametrize("B", [64, 256, 300, 1024, 1])
@pytest.mark.parametrize("K", [5, 10, 15, 128])
def test_dmf_grads_kernel(dev, B, K):
    x = _grads_inputs(np.random.default_rng(B * K), B, K, dev)
    hp = dict(alpha=0.1, beta=0.01, gamma=0.02)
    before = ops.dmf_grads.launches
    got = ops.dmf_grads(*x, **hp)
    torch.cuda.synchronize()
    assert ops.dmf_grads.launches == before + 1
    for a, b in zip(got, ref.dmf_grads_ref(*x, *hp.values())):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("B", [256, 2048, 1])
def test_dmf_grads_kernel_is_the_fused_step_kernel(dev, B):
    x = _grads_inputs(np.random.default_rng(B), B, 10, dev)
    theta, hp = 0.1, dict(alpha=0.1, beta=0.1, gamma=0.01)
    gu, gp, gq = ops.dmf_grads(*x, **hp)
    du, gp3, dq, _ = ops.dmf_fused_step(*x, theta=theta, **hp)
    assert torch.equal(gp, gp3)
    for a, b in ((-theta * gu, du), (-theta * gq, dq)):
        ulp = torch.abs(torch.nextafter(b, torch.full_like(b, float("inf"))) - b)
        assert ((a - b).abs() <= ulp).all()


def _hold_grads(got, x, hp):
    """Each gradient within 2e-5 abs + rel of the plain version, plus the
    bound on two fp32 orders of the residual's K-term dot (2·K·2⁻²⁴·c·
    Σ|u·v|) times the residual's factor (|v| for gu, |u| for gp and gq):
    at K=128 two orders differ by more than 2e-5 on a few elements."""
    u, p, q, r, c = x
    v = p + q
    dot_err = (2 * u.shape[1] * 2.0**-24 * c * (u * v).abs().sum(-1))[:, None]
    for g, w, factor in zip(got, ref.dmf_grads_ref(*x, *hp.values()), (v.abs(), u.abs(), u.abs())):
        assert bool(((g - w).abs() <= 2e-5 * (1 + w.abs()) + dot_err * factor).all())


@pytest.mark.parametrize("B", [1, 32, 33, 256, 2048, 5000])
@pytest.mark.parametrize("K", [5, 10, 16, 128])
def test_dmf_grads_kernel_across_layouts(dev, B, K):
    """Kernel 9 in the wrapper's layout and at 1, 16, 64 and 128 rows a
    block (one block, several, a ragged last block; K fixed at build time
    and at run time): against its plain version, every layout equal to
    the wrapper's bit for bit, and gp equal to kernel 3's gp bit for
    bit."""
    from repro_torch.kernels import dmf_update
    x = _grads_inputs(np.random.default_rng(B + K), B, K, dev)
    hp = dict(alpha=0.1, beta=0.1, gamma=0.01)
    got = ops.dmf_grads(*x, **hp)
    _hold_grads(got, x, hp)
    for rows in (1, 16, 64, 128):
        other = dmf_update.grads_on_layout(*x, *hp.values(), dict(rows=rows))
        for a, b in zip(other, got):
            assert torch.equal(a, b), rows
    assert torch.equal(got[1], ops.dmf_fused_step(*x, theta=0.1, **hp)[1])
    with pytest.raises(RuntimeError):                      # more rows than threads
        dmf_update.grads_on_layout(*x, *hp.values(), dict(rows=129))
    torch.cuda.synchronize()


def _hold_mix(Y, M, X):
    want = ref.gossip_mix_ref(M.float(), X.float())
    bound = 1e-5 + 1e-5 * ref.gossip_mix_ref(M.float().abs(), X.float().abs())
    assert Y.dtype == torch.float32 and Y.shape == want.shape
    assert ((Y - want).abs() <= bound).all(), float((Y - want).abs().max())


@pytest.mark.parametrize("I,F", [(128, 128), (200, 333), (512, 64), (77, 1000), (1, 5), (130, 1)])
def test_gossip_mix_kernel(dev, I, F):
    rng = np.random.default_rng(I + F)
    M = torch.as_tensor(rng.normal(size=(I, I)).astype(np.float32), device=dev)
    X = torch.as_tensor(rng.normal(size=(I, F)).astype(np.float32), device=dev)
    M[:, I // 2:] = 0.0                                   # a sparse half, like a walk matrix
    before = ops.gossip_mix_op.launches
    Y = ops.gossip_mix_op(M, X)
    torch.cuda.synchronize()
    assert ops.gossip_mix_op.launches == before + 1
    _hold_mix(Y, M, X)


def test_gossip_mix_kernel_upcasts_bf16(dev):
    rng = np.random.default_rng(0)
    M = torch.as_tensor(rng.normal(size=(64, 64)), device=dev).bfloat16()
    X = torch.as_tensor(rng.normal(size=(64, 32)), device=dev).bfloat16()
    Y = ops.gossip_mix_op(M, X)
    torch.cuda.synchronize()
    _hold_mix(Y, M, X)


def _walk_like(rng, I, per_row=10):
    """A row-stochastic-looking sparse M: 1 on the diagonal and ~per_row
    positive weights a row, zeros elsewhere (like the walk matrix)."""
    M = np.zeros((I, I), np.float32)
    for i in range(I):
        cols = rng.choice(I, per_row, replace=False)
        M[i, cols] = rng.random(per_row).astype(np.float32) / per_row
        M[i, i] = 1.0
    return M


@pytest.mark.parametrize("I,F", [(512, 1024), (77, 1000), (130, 1), (300, 333)])
def test_gossip_mix_sparse_route_equals_dense_route(dev, I, F):
    from repro_torch.kernels import gossip_mix
    rng = np.random.default_rng(I * F)
    M = torch.as_tensor(_walk_like(rng, I, min(10, I)), device=dev)
    X = torch.as_tensor(rng.normal(size=(I, F)).astype(np.float32), device=dev)
    sparse = gossip_mix.mix_on_route(M, X, "sparse")
    dense = gossip_mix.mix_on_route(M, X, "dense")
    torch.cuda.synchronize()
    assert torch.equal(sparse, dense)
    _hold_mix(sparse, M, X)


def test_gossip_mix_routes_by_density_and_finiteness(dev):
    from repro_torch.kernels import gossip_mix
    rng = np.random.default_rng(5)
    I, F = 2048, 300                      # above the count's size floor
    assert gossip_mix.counts_needed(I, F)
    M = torch.as_tensor(_walk_like(rng, I), device=dev)
    X = torch.as_tensor(rng.normal(size=(I, F)).astype(np.float32), device=dev)
    Y = ops.gossip_mix_op(M, X)
    assert ops.gossip_mix_op.last_route == "sparse"
    _hold_mix(Y, M, X)
    Md = torch.as_tensor(rng.normal(size=(I, I)).astype(np.float32), device=dev)
    _hold_mix(ops.gossip_mix_op(Md, X), Md, X)
    assert ops.gossip_mix_op.last_route == "dense"


@pytest.mark.parametrize("I,F", [(2048, 300), (512, 1024), (77, 1000)])
def test_gossip_mix_nonfinite_x_gives_the_plain_nan_pattern(dev, I, F):
    from repro_torch.kernels import gossip_mix
    rng = np.random.default_rng(I + 7)
    M = torch.as_tensor(_walk_like(rng, I, min(10, I)), device=dev)
    X = torch.as_tensor(rng.normal(size=(I, F)).astype(np.float32), device=dev)
    X[3, 5] = float("inf")
    X[I - 1, F - 1] = float("-inf")
    X[I // 2, 0] = float("nan")
    Y = ops.gossip_mix_op(M, X)
    torch.cuda.synchronize()
    assert ops.gossip_mix_op.last_route == "dense"
    want = ref.gossip_mix_ref(M, X)
    assert torch.equal(torch.isnan(Y), torch.isnan(want))
    assert torch.equal(torch.isinf(Y), torch.isinf(want))
    fin = torch.isfinite(want)
    bound = 1e-5 + 1e-5 * ref.gossip_mix_ref(M.abs(), torch.where(torch.isfinite(X), X.abs(), 0))
    assert ((Y - want).abs()[fin] <= bound[fin]).all()
    if gossip_mix.counts_needed(I, F):   # the count saw the non-finite X
        assert gossip_mix._count("t", M, X)[1] is False


@pytest.mark.parametrize("B", [1, 256, 1000, 5000])
@pytest.mark.parametrize("dp", [False, True])
@pytest.mark.parametrize("K", [10, 8, 16])   # 10 fixed at build time; 16 too wide to stage
def test_dmf_fused_steps_one_launch_same_bits_twice(dev, B, dp, K):
    rng = np.random.default_rng(B + dp)
    x = [rng.normal(0, 0.5, (B, K)).astype(np.float32) for _ in range(3)]
    r = (rng.random(B) < 0.25).astype(np.float32)
    x += [r, np.where(r > 0, 1.0, 1 / 3).astype(np.float32)]
    x = [torch.as_tensor(a, device=dev) for a in x]
    hp = dict(theta=0.1, alpha=0.1, beta=0.1, gamma=0.01)
    if dp:
        z = torch.as_tensor((0.5 * rng.normal(size=(B, K))).astype(np.float32), device=dev)
        kern, plain = ops.dmf_fused_step_dp, ref.dmf_fused_step_dp_ref
        args, kw, pargs = (*x, z), dict(hp, clip=0.5), (*x, z, *hp.values(), 0.5)
    else:
        kern, plain = ops.dmf_fused_step, ref.dmf_fused_step_ref
        args, kw, pargs = x, hp, (*x, *hp.values())
    before = kern.launches
    first = kern(*args, **kw)
    second = kern(*args, **kw)
    torch.cuda.synchronize()
    assert kern.launches == before + 2
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    want = plain(*pargs)
    for a, b in zip(first[:3], want[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=TOL)
    torch.testing.assert_close(first[3], want[3], rtol=TOL, atol=0)


def test_scatters_give_the_same_bits_on_two_runs(dev):
    from repro_torch.core import baselines, dmf, graph
    rng = np.random.default_rng(0)
    I, J, K, B, S = 60, 40, 10, 256, 7
    idx = np.concatenate([np.arange(I)[:, None], rng.integers(0, I, (I, S - 1))], 1)
    nbr = graph.NeighborTable(torch.as_tensor(idx, device=dev),
                              torch.as_tensor(rng.random((I, S)).astype(np.float32), device=dev))
    cfg = dmf.DMFConfig(n_users=I, n_items=J, dim=K)
    ui = torch.as_tensor(rng.integers(0, 8, B), device=dev)       # many duplicate pairs
    vj = torch.as_tensor(rng.integers(0, 4, B), device=dev)
    r = torch.as_tensor((rng.random(B) < 0.3).astype(np.float32), device=dev)
    conf = torch.ones(B, device=dev)
    runs = []
    for _ in range(2):
        st = dmf.init_state(cfg, np.random.default_rng(1), device=dev)
        st.P.normal_(generator=torch.Generator(dev).manual_seed(2))
        dmf._sparse_batch_update(st.U, st.P, st.Q, nbr.idx, nbr.wgt, ui, vj, r, conf, cfg)
        runs.append(st)
    for n in "UPQ":
        assert torch.equal(getattr(runs[0], n), getattr(runs[1], n))
    train = np.stack([rng.integers(0, I, 500), rng.integers(0, J, 500)], 1)
    mcfg = baselines.MFConfig(n_users=I, n_items=J, batch_size=64)
    a, b = (baselines.fit_mf(mcfg, train, epochs=2, device=dev)[0] for _ in range(2))
    assert torch.equal(a.U, b.U) and torch.equal(a.V, b.V)


def _robust_world(dev):
    """The reference robustness tests' small world (80 users, 50 items, 600
    ratings, K=6, B=64), its neighbor table on ``dev``."""
    from repro_torch.core import dmf, graph
    from repro_torch.data import synthetic_poi
    ds = synthetic_poi.generate(synthetic_poi.POIDatasetConfig(
        n_users=80, n_items=50, n_ratings=600, n_cities=4, seed=0))
    gcfg = graph.GraphConfig(n_neighbors=2, walk_length=3)
    W = graph.build_adjacency(ds.user_coords, ds.user_city, gcfg)
    cfg = dmf.DMFConfig(n_users=ds.n_users, n_items=ds.n_items, dim=6, batch_size=64,
                        beta=0.1, gamma=0.01)
    return ds, graph.walk_neighbor_table(W, gcfg, device=dev), cfg


@pytest.mark.parametrize("dp", [False, True])
def test_trivial_plan_and_inactive_defense_are_bitexact_on_the_card(dev, dp):
    import dataclasses

    from repro_torch.core import dmf
    from repro_torch.robustness import ChurnConfig, DefenseConfig
    ds, nbr, cfg = _robust_world(dev)
    if dp:
        cfg = dataclasses.replace(cfg, dp_sigma=0.5, dp_clip=0.25, dp_seed=3)
    plain = dmf.fit(cfg, ds.train, nbr, epochs=3, device=dev)
    got = dmf.fit(cfg, ds.train, nbr, epochs=3, churn=ChurnConfig(), defense=DefenseConfig(),
                  device=dev)
    assert got.train_losses == plain.train_losses and got.privacy == plain.privacy
    for n in "UPQ":
        assert torch.equal(getattr(got.state, n), getattr(plain.state, n)), n


def test_resume_is_bit_identical_on_the_card(dev, tmp_path):
    import dataclasses

    from repro_torch.core import dmf
    from repro_torch.robustness import ChurnConfig, DefenseConfig
    ds, nbr, cfg = _robust_world(dev)
    cfg = dataclasses.replace(cfg, dp_sigma=0.5, dp_clip=0.25, dp_seed=3)
    kw = dict(churn=ChurnConfig(dropout=0.2, delay_classes=(0, 1, 2), late_frac=0.1, seed=17),
              defense=DefenseConfig(screen=True, aggregation="trim"), device=dev)
    full = dmf.fit(cfg, ds.train, nbr, epochs=4, checkpoint_dir=tmp_path, checkpoint_every=2,
                   **kw)
    resumed = dmf.fit(cfg, ds.train, nbr, epochs=4, resume_from=tmp_path / "step_2", **kw)
    assert resumed.train_losses == full.train_losses and resumed.privacy == full.privacy
    for n in "UPQ":
        assert torch.equal(getattr(resumed.state, n), getattr(full.state, n)), n
        assert getattr(resumed.state, n).device.type == "cuda"


def test_robust_epoch_on_the_card_agrees_with_the_cpu(dev):
    """An attacked, screened, trimmed, churned DP run on the card against
    the same run on the CPU: the scatters sum duplicates in another fixed
    order on each device, so losses within 1e-4 relative and factors within
    1e-5 absolute (the card-vs-CPU bar of the training slice)."""
    import dataclasses

    from repro_torch.core import dmf, graph
    from repro_torch.robustness import AttackConfig, ChurnConfig, DefenseConfig
    ds, nbr, cfg = _robust_world(dev)
    cfg = dataclasses.replace(cfg, dp_sigma=0.3, dp_clip=1.0, dp_seed=3)
    kw = dict(epochs=3, attack=AttackConfig(family="norm_inflate", frac=0.2, scale=100.0, seed=5),
              defense=DefenseConfig(screen=True, norm_cap=2.0, aggregation="trim",
                                    trim_frac=0.25),
              churn=ChurnConfig(dropout=0.2, delay_classes=(0, 1), seed=4))
    card = dmf.fit(cfg, ds.train, nbr, device=dev, **kw)
    host = dmf.fit(cfg, ds.train, graph.NeighborTable(nbr.idx.cpu(), nbr.wgt.cpu()),
                   device="cpu", **kw)
    np.testing.assert_allclose(card.train_losses, host.train_losses, rtol=1e-4)
    for n in "UPQ":
        torch.testing.assert_close(getattr(card.state, n).cpu(), getattr(host.state, n),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("aggregation", ["trim", "median"])
def test_robust_combine_on_the_card_agrees_with_the_cpu(dev, aggregation):
    from repro_torch.robustness import byzantine
    rng = np.random.default_rng(0)
    M, nbk, cap, K = 600, 96, 8, 10
    cells = rng.permutation(nbk * cap)[:M]
    bucket, pos = (cells // cap).astype(np.int32), (cells % cap).astype(np.int32)
    bucket[rng.random(M) < 0.2] = nbk
    pos[bucket == nbk] = 0
    vals = rng.normal(size=(M, K)).astype(np.float32)
    vals[rng.random((M, K)) < 0.05] = np.nan
    vals[bucket == nbk] = 0.0
    validity = ((bucket < nbk) & (rng.random(M) < 0.9)).astype(np.float32)
    d = byzantine.DefenseConfig(aggregation=aggregation, trim_frac=0.25)
    args = [torch.from_numpy(x) for x in (vals, validity, bucket, pos)]
    host = byzantine.robust_combine(*args, nbk, cap, d)
    card = byzantine.robust_combine(*(x.to(dev) for x in args), nbk, cap, d)
    # median picks values: the same bits; the trimmed sum over the cap axis
    # may add in another order on the card, so within 1e-6 relative
    np.testing.assert_array_equal(np.isnan(card.cpu().numpy()), np.isnan(host.numpy()))
    np.testing.assert_allclose(card.cpu().numpy(), host.numpy(),
                               rtol=0 if aggregation == "median" else 1e-6, atol=0)


def test_telemetry_leaves_a_dp_fit_bit_for_bit_on_the_card(dev):
    import dataclasses

    from repro_torch.core import dmf
    ds, nbr, cfg = _robust_world(dev)
    cfg = dataclasses.replace(cfg, dp_sigma=1.0, dp_clip=0.5, dp_seed=3)
    off = dmf.fit(cfg, ds.train, nbr, epochs=2, device=dev)
    on = dmf.fit(cfg, ds.train, nbr, epochs=2, telemetry=True, device=dev)
    assert on.train_losses == off.train_losses and on.privacy == off.privacy
    for n in "UPQ":
        assert torch.equal(getattr(on.state, n), getattr(off.state, n)), n
    assert [ev["epoch"] for ev in on.telemetry] == [0, 1]
    assert all(ev["n_messages"] > 0 and ev["dp_eps"] > 0 for ev in on.telemetry)


def _scheduled_engine(dev):
    from repro_torch.core import dmf
    from repro_torch.serving import ServingConfig, ServingEngine, index_from_dataset
    ds, nbr, cfg = _robust_world(dev)
    state = dmf.fit(cfg, ds.train, nbr, epochs=2, device=dev).state

    def engine():
        return ServingEngine(state, index_from_dataset(ds), ServingConfig(microbatch=8, k=5),
                             train=ds.train, nbr=nbr, dmf_cfg=cfg, device=dev)
    return ds, engine


def test_scheduler_slates_equal_recommend_on_the_card(dev):
    from repro_torch.scheduling import Scheduler, WorkloadConfig, generate
    ds, engine = _scheduled_engine(dev)
    reqs = generate(WorkloadConfig(n_requests=60, rate_rps=500.0, users="powerlaw", slo_ms=0,
                                   seed=3), ds.n_users)
    rep = Scheduler(engine()).run(reqs, ingest_events=[ds.test[:8]])
    served = rep.served()
    assert len(served) == len(reqs) and rep.n_ingest_windows == 1
    pre = [r for r in served if r.ingest_epoch == 0]
    vals, idx, flags = engine().recommend([r.user for r in pre], return_flags=True)
    for j, r in enumerate(pre):
        np.testing.assert_array_equal(r.vals, vals[j])
        np.testing.assert_array_equal(r.idx, idx[j])
        assert r.fallback == bool(flags[j])


def test_profiled_scheduler_run_records_a_kernel_per_dispatch(dev, tmp_path):
    from repro_torch.obs import trace as trace_lib
    from repro_torch.scheduling import Scheduler, WorkloadConfig, generate
    ds, engine = _scheduled_engine(dev)
    eng = engine()
    eng.serve_microbatch(np.arange(8))        # builds the kernels outside the window
    reqs = generate(WorkloadConfig(n_requests=64, rate_rps=2000.0, slo_ms=0, seed=1),
                    ds.n_users)
    tracer = trace_lib.Tracer(enabled=True)
    launches = ops.serve_topk_rows.launches
    with tracer.torch_profiler(tmp_path, device=dev):
        rep = Scheduler(eng).run(reqs)
    n_disp = sum(rep.n_dispatches_per_shard)
    assert ops.serve_topk_rows.launches - launches == n_disp
    busy = trace_lib.device_busy(tracer.profiler_traces[-1])
    assert busy["n_kernel"] >= n_disp and 0.0 < busy["busy_share"] <= 1.0


@pytest.mark.parametrize("backend,n_shards", [("nccl", 1), ("gloo", 2)])
def test_sharded_fit_on_the_card_matches_the_unsharded_fit(dev, backend, n_shards):
    """Learner-sharded `fit` DP off and on, and the sharded epoch driven by
    hand (so that one nccl rank runs it too), on the small world: within
    1e-5 of the unsharded card run; `evaluate(n_shards=D)` equal to the
    unsharded metrics. Two gloo ranks share the one card."""
    import _torch_sharded_ranks as ranks
    from repro_torch.core import dmf
    from repro_torch.kernels import build
    from repro_torch.launch import mesh
    if backend == "nccl" and torch.cuda.device_count() < n_shards:
        pytest.skip(f"nccl needs {n_shards} cards")
    build.load()                        # before the ranks start
    got = mesh.spawn_ranks(ranks.card_case, n_shards, backend=backend, device="cuda",
                           timeout_s=300.0, args=(n_shards,))
    ds, nbr = ranks.world()
    nbr = type(nbr)(nbr.idx.to(dev), nbr.wgt.to(dev))
    for name, kw in (("plain", {}), ("dp", ranks.DP)):
        ref = dmf.fit(ranks.config(ds, **kw), ds.train, nbr, epochs=ranks.EPOCHS,
                      test=ds.test, device=dev)
        for run in (got[name], got[name + "_by_epoch"]):
            np.testing.assert_allclose(run["losses"], ref.train_losses, rtol=0, atol=TOL)
            for n in "UPQ":
                np.testing.assert_allclose(run[n], getattr(ref.state, n).cpu().numpy(),
                                           rtol=0, atol=TOL, err_msg=n)
        if name == "plain":
            assert got["evaluate"] == dmf.evaluate(ref.state, ds.train, ds.test, ds.n_users,
                                                   ds.n_items, device=dev)


def test_sharded_serving_on_the_card_equals_the_one_device_engine(dev):
    """Two gloo ranks on the one card serve the small world's requests
    through `ServingEngine(n_shards=2)` (kernel 5 in place pruned, kernel
    2 on the rank's rows dense): the slates of the one-device engine on
    the card, bit for bit, values and ids."""
    import _torch_sharded_serving_ranks as ranks
    from repro_torch.core import dmf
    from repro_torch.kernels import build
    from repro_torch.launch import mesh
    build.load()                        # before the ranks start
    ds, nbr = ranks.world()
    st = dmf.fit(ranks.config(ds), ds.train, nbr, epochs=6, device="cpu").state
    states = {"fit6": tuple(x.numpy() for x in (st.U, st.P, st.Q))}
    got = mesh.spawn_ranks(ranks.card_case, 2, backend="gloo", device="cuda",
                           timeout_s=300.0, args=(2, states))
    for prune in (True, False):
        for a, b in zip(got[prune]["sharded"], got[prune]["one"]):
            np.testing.assert_array_equal(a, b)


LM_ARCHS = ["minicpm3-4b", "llama-3.2-vision-90b", "deepseek-v2-lite-16b", "qwen1.5-4b",
            "musicgen-medium", "minitron-4b", "deepseek-v2-236b", "mamba2-2.7b",
            "jamba-1.5-large-398b", "yi-34b", "yi-34b-swa"]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_serving_on_the_card_agrees_with_the_cpu(dev, arch):
    """The LM serving path at `reduced()` width in fp32 (TF32 off): the same
    numpy weights carried to the card and to the CPU give prefill logits,
    4 decode steps' logits and every cache leaf within 1e-4 × the CPU
    tensor's largest magnitude. None of the port's kernels launches."""
    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.models import config as mc
    from repro_torch.models import transformer
    cfg = mc.reduced(registry.get_config(arch))
    tree = transformer.params_to_numpy(transformer.init_params(cfg, seed=0, device="cpu"))
    rng = np.random.default_rng(0)
    B, S, steps = 2, 8, 4
    shape = (B, S + steps, cfg.n_codebooks) if cfg.n_codebooks else (B, S + steps)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, shape))
    media = (torch.as_tensor(rng.normal(0, 0.5, (B, cfg.n_image_tokens, cfg.d_model)),
                             dtype=torch.float32) if cfg.n_image_tokens else None)
    for kern in ops.KERNELS:
        kern.launches = 0
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        runs = {}
        for where in ("cpu", dev):
            model = transformer.params_from_numpy(tree, cfg, device=where)
            batch = {"tokens": tokens[:, :S].to(where)}
            if media is not None:
                batch["media"] = media.to(where)
            logits, pcache = serve.make_prefill_step(cfg, device=where)(model, batch)
            cache = serve.cache_from_prefill(cfg, pcache, S + steps, device=where)
            step = serve.make_decode_step(cfg, device=where)
            outs = [logits]
            for t in range(S, S + steps):
                logits, cache = step(model, cache, tokens[:, t:t + 1].to(where), t)
                outs.append(logits)
            runs[str(where)] = ([o.cpu() for o in outs],
                                {f"{p}/{n}": v.cpu() for p, c in cache.items() for n, v in c.items()})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (cpu_logits, cpu_cache), (card_logits, card_cache) = runs["cpu"], runs[str(dev)]
    for got, want in zip(card_logits, cpu_logits):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-4 * float(want.abs().max()))
    for name, want in cpu_cache.items():
        np.testing.assert_allclose(card_cache[name].numpy(), want.numpy(), rtol=0,
                                   atol=1e-4 * float(want.abs().max()), err_msg=name)
    assert all(kern.launches == 0 for kern in ops.KERNELS)


def _lm_grads(model, batch) -> dict:
    """loss_fn's loss and gradients (on the host, by the reference's paths)."""
    from repro_torch.models import transformer
    model.zero_grad(set_to_none=True)
    loss = transformer.loss_fn(model, batch)
    loss.backward()
    grads = {name: p.grad.detach().cpu() for name, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.detach().cpu(), grads


def _lm_batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, shape).astype(np.int32)}
    if cfg.n_image_tokens:
        batch["media"] = rng.normal(0, 0.5, (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _no_tf32():
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    return tf32


@pytest.mark.parametrize("arch", LM_ARCHS[:-1])
def test_lm_training_step_on_the_card_agrees_with_the_cpu(dev, arch):
    from repro_torch import optim
    from repro_torch.configs import registry
    from repro_torch.launch import train
    from repro_torch.models import config as mc
    from repro_torch.models import transformer
    cfg = mc.reduced(registry.get_config(arch))
    tree = transformer.params_to_numpy(transformer.init_params(cfg, seed=0, device="cpu"))
    batch = _lm_batch(cfg, 2, 32, 1)
    opt = optim.adamw(optim.linear_warmup_cosine(3e-3, 2, 10), weight_decay=0.01, eps=1e-3)
    for kern in ops.KERNELS:
        kern.launches = 0
    tf32 = _no_tf32()
    try:
        runs = {}
        for where in ("cpu", dev):
            state = train.train_state_from_numpy(cfg, opt, tree, device=where)
            tb = {k: torch.as_tensor(v, device=where) for k, v in batch.items()}
            _, grads = _lm_grads(state.params, tb)
            step, _ = train.make_train_step(cfg, opt, device=where)
            state, m = step(state, tb)
            runs[str(where)] = (m["loss"].cpu(), grads, transformer.params_to_numpy(state.params))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (l_cpu, g_cpu, p_cpu), (l_card, g_card, p_card) = runs["cpu"], runs[str(dev)]
    np.testing.assert_allclose(float(l_card), float(l_cpu), rtol=1e-4)
    for name, want in g_cpu.items():
        np.testing.assert_allclose(g_card[name].numpy(), want.numpy(), rtol=0,
                                   atol=1e-4 * float(want.abs().max()), err_msg=name)
    from repro_torch.utils import tree as tree_lib
    for (name, want), (_, got) in zip(tree_lib.tree_paths(p_cpu), tree_lib.tree_paths(p_card)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * float(np.abs(want).max()),
                                   err_msg=name)
    assert all(kern.launches == 0 for kern in ops.KERNELS)


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "deepseek-v2-lite-16b", "jamba-1.5-large-398b"])
def test_lm_remat_on_the_card_is_bit_for_bit(dev, arch):
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.models import config as mc
    from repro_torch.models import transformer
    cfg = mc.reduced(registry.get_config(arch), compute_dtype="bfloat16")
    tree = transformer.params_to_numpy(transformer.init_params(cfg, seed=0, device="cpu"))
    batch = {k: torch.as_tensor(v, device=dev) for k, v in _lm_batch(cfg, 2, 128, 2).items()}
    runs = [_lm_grads(transformer.params_from_numpy(
        tree, dataclasses.replace(cfg, remat=remat), device=dev), batch) for remat in (False, True)]
    (l0, g0), (l1, g1) = runs
    assert torch.equal(l0, l1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


def test_lm_adamw_in_place_on_the_card_equals_the_functional_form(dev):
    from repro_torch import optim
    from repro_torch.utils.tree import tree_map
    gen = torch.Generator(device=dev).manual_seed(0)
    rand = lambda shape, s=0.1: torch.randn(shape, generator=gen, device=dev) * s
    params = {"blocks": {"0": {"attn": {"bq": rand((3, 4, 8)), "wq": rand((3, 64, 4, 8))},
                               "ln1": rand((3, 64))}},
              "embed": rand((1000, 64)), "final_norm": rand((64,))}
    decay = lambda path: not path.split("/")[-1].startswith(("b", "ln", "final"))
    opt = optim.adamw(optim.linear_warmup_cosine(3e-3, 2, 10), weight_decay=0.01,
                      grad_clip_norm=0.5, mask=decay)
    a, b = tree_map(torch.clone, params), tree_map(torch.clone, params)
    sa, sb = opt.init(a), opt.init(b)
    for _ in range(4):
        grads = tree_map(lambda x: rand(tuple(x.shape), 1.0), params)
        upd, sa = opt.update(grads, sa, a)
        a = optim.apply_updates(a, upd)
        opt.update_(grads, sb, b)
        for x, y in zip(optim.optimizers.leaves(a) + optim.optimizers.leaves(sa.inner),
                        optim.optimizers.leaves(b) + optim.optimizers.leaves(sb.inner)):
            assert torch.equal(x, y)


def test_lm_gossip_on_the_card_converges(dev):
    """`test_gossip_training_converges_small_lm`'s config and assertions."""
    from repro_torch import optim
    from repro_torch.configs import registry
    from repro_torch.core import gossip
    from repro_torch.data.lm_pipeline import LMDataConfig, SyntheticLM
    from repro_torch.launch import train
    from repro_torch.models import config as mc
    cfg = mc.reduced(registry.get_config("qwen1.5-4b"), n_kv_heads=4, vocab_size=256,
                     d_model=128, d_ff=256, n_heads=4, head_dim=32)
    step, init_fn = train.make_train_step(cfg, optim.adamw(6e-3), sync="gossip",
                                          gossip=gossip.GossipConfig(walk_length=2),
                                          n_learners=4, device=dev)
    state = init_fn(0)
    data = SyntheticLM(LMDataConfig(vocab_size=256, seq_len=64, batch_size=16, seed=0))
    losses = []
    for i in range(60):
        state, m = step(state, data.batch(i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3, (losses[0], losses[-1])
    assert float(m["consensus_err"]) < 0.5

"""DMF applied to LM training — port of `examples/decentralized_lm.py`:
train the same tiny LM with (a) centralized all-reduce and (b) the
paper's gossip protocol (per-learner replicas, D-hop ring mixing,
personal-parameter partition), and compare loss curves plus learner
consensus.

    PYTHONPATH=src python -m repro_torch.examples.decentralized_lm --steps 40
    PYTHONPATH=src python -m repro_torch.examples.decentralized_lm --device cpu --steps 10

The reference needs 8 host devices for its (4, 2) mesh, learners along
``data``; here both syncs run on one device (`launch/train.py`), the L
learners (``--learners``, the reference's 4) stacked on a leading dim.
The printed lines are the reference's.
"""
import argparse

from repro_torch import device as device_lib
from repro_torch.configs import registry
from repro_torch.core import gossip as gossip_lib
from repro_torch.data.lm_pipeline import LMDataConfig, SyntheticLM
from repro_torch.launch.train import make_train_step
from repro_torch.models import config as mc
from repro_torch.optim import adamw


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--walk-length", type=int, default=2)
    ap.add_argument("--learners", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = device_lib.resolve(args.device)

    cfg = mc.reduced(
        registry.get_config("qwen1.5-4b"), n_kv_heads=2, vocab_size=256,
        d_model=128, d_ff=256, n_heads=4, head_dim=32,
    )
    data = SyntheticLM(LMDataConfig(vocab_size=256, seq_len=64, batch_size=16))

    curves, consensus = {}, None
    for sync in ["allreduce", "gossip"]:
        gcfg = gossip_lib.GossipConfig(
            learner_axis="data", walk_length=args.walk_length)
        step, init_fn = make_train_step(
            cfg, adamw(3e-3), sync=sync, gossip=gcfg, n_learners=args.learners, device=dev)
        state = init_fn(0)
        losses = []
        for i in range(args.steps):
            state, m = step(state, data.batch(i))
            losses.append(float(m["loss"]))
            if "consensus_err" in m:
                consensus = float(m["consensus_err"])
            if i % 10 == 0:
                extra = (f" consensus_err={consensus:.3f}"
                         if "consensus_err" in m else "")
                print(f"[{sync:9s}] step {i:3d} loss {losses[-1]:.4f}{extra}")
        curves[sync] = losses

    print("\nfinal loss: allreduce=%.4f gossip=%.4f" % (
        curves["allreduce"][-1], curves["gossip"][-1]))
    gap = curves["gossip"][-1] - curves["allreduce"][-1]
    print(f"gossip-vs-centralized gap: {gap:+.4f} "
          f"(paper's claim: decentralized training tracks centralized; "
          f"collective traffic is neighbor-only collective-permutes)")
    return {"curves": curves, "consensus_err": consensus}


if __name__ == "__main__":
    main()

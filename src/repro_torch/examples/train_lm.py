"""End-to-end LM training example — port of `examples/train_lm.py`: train a
decoder of any --arch family (reduced to ~100M params by default) with the
full stack — config, data pipeline, AdamW with a warmup-cosine schedule,
checkpoints — through the ``allreduce`` step of `launch/train.py`.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300 --arch qwen1.5-4b
    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 50 --d-model 256  # quick
    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu --steps 3 \\
        --d-model 64 --n-layers 1 --seq-len 16 --batch 2 --vocab 128

The flags, the schedule (``linear_warmup_cosine(3e-3, 20, steps)``,
weight decay 0.01) and the printed lines are the reference's. Checkpoints
(`checkpoint/ckpt.py`, the reference's layout, parameters as the
reference's tree) go to ``--ckpt-dir`` under the temporary directory by
default, every ``--ckpt-every`` steps and at the end.
"""
import argparse
import pathlib
import tempfile
import time

from repro_torch import device as device_lib
from repro_torch.checkpoint import ckpt
from repro_torch.configs import registry
from repro_torch.data.lm_pipeline import LMDataConfig, SyntheticLM
from repro_torch.launch import train
from repro_torch.models import config as mc
from repro_torch.models import transformer
from repro_torch.optim import adamw, linear_warmup_cosine
from repro_torch.utils.tree import tree_size


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-4b", choices=registry.ARCH_IDS)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--n-layers", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--ckpt-dir", default=str(pathlib.Path(tempfile.gettempdir()) / "repro_lm_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = device_lib.resolve(args.device)

    base = registry.get_config(args.arch)
    cfg = mc.reduced(
        base,
        d_model=args.d_model,
        n_layers=args.n_layers * len(base.period),
        n_heads=max(4, args.d_model // 64),
        n_kv_heads=max(2, min(base.n_kv_heads, args.d_model // 128)),
        d_ff=0 if base.n_routed_experts and not base.ssm_d_state else args.d_model * 4,
        vocab_size=args.vocab,
        loss_chunk=128,
    )
    opt = adamw(linear_warmup_cosine(3e-3, 20, args.steps), weight_decay=0.01)
    step, init_fn = train.make_train_step(cfg, opt, device=dev)
    state = init_fn(0)
    n = tree_size(state.params)
    print(f"arch={cfg.name} params={n/1e6:.1f}M layers={cfg.n_layers} "
          f"d={cfg.d_model}")

    data = SyntheticLM(LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len, batch_size=args.batch))

    ck = pathlib.Path(args.ckpt_dir)
    losses = []
    t0 = time.time()
    for i in range(args.steps):
        b = data.batch(i, n_codebooks=cfg.n_codebooks)
        state, metrics = step(state, b)
        if i % 20 == 0 or i == args.steps - 1:
            loss = float(metrics["loss"])
            tok_s = args.batch * args.seq_len * (i + 1) / (time.time() - t0)
            print(f"step {i:4d} loss {loss:.4f} tok/s {tok_s:,.0f}")
            losses.append((i, loss))
        if args.ckpt_every and i and i % args.ckpt_every == 0:
            ckpt.save(ck / f"step_{i}", transformer.params_to_numpy(state.params), step=i)
    ckpt.save(ck / f"step_{args.steps}", transformer.params_to_numpy(state.params),
              step=args.steps)
    print(f"checkpoints in {ck}; latest step {ckpt.latest_step(ck)}")
    return {"cfg": cfg, "state": state, "losses": losses, "ckpt_dir": ck}


if __name__ == "__main__":
    main()

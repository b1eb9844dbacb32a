"""Training loop of the port (counterpart of the reference's
``launch/train.py``): the loss, the train step and a runnable loop.

    python -m repro_torch.launch.train --arch qwen3-0.6b [--full]
        [--steps 20 --seq-len 128 --batch 4] [--device cpu]
        [--ckpt PATH --save-every K]

The loop runs on the card unless asked for the CPU (``--device cpu``),
draws its weights from ``torch.Generator().manual_seed(0)`` and feeds the
reference pipeline's synthetic Zipf stream (``data/pipeline.py``), with
zero ``prefix_embeds`` for the VLM family and zero ``frames`` at
``seq_len // enc_len_ratio`` for the enc-dec one, as the reference does.
The step runs eagerly, with no arena and no capture: the reference's
``jax.jit`` of the step has no counterpart here. Gradients come from
``torch.autograd``; a Mamba2 layer's SSD core on the kernel cores is
``repro_torch::ssd_chunk``, whose backward is the hand-written
``ssd_chunk_bwd`` kernel on the card. A checkpoint holds ``(params,
opt_state)`` with ``meta={"step": ...}`` in the reference's format, and
the pipeline is seekable by step, so a resume continues exactly.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Any

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ARCH_IDS, get_config, get_reduced
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models.api import for_config
from repro_torch.optim import adamw
from repro_torch.runtime.device import resolve_device
from repro_torch.tree_util import from_leaves, leaves, tree_map


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None].long(), dim=-1)[..., 0]
    return (logz - gold).mean()


def make_loss_fn(model, remat: bool = True, constrain=None, **tables):
    """The reference's loss: cross-entropy over the text positions plus
    0.01 × the MoE aux loss. ``constrain`` goes to the forward (a sharded
    step); ``tables`` are the model's RoPE tables when the caller passes
    its own (a sharded step passes them replicated)."""
    def loss_fn(params, batch):
        logits, aux = model.forward(params, batch, remat=remat, constrain=constrain,
                                    **tables)
        labels = batch["labels"]
        # VLM prefix positions have no labels: forward prepends
        # n_prefix_tokens embeddings, so logits is longer than tokens
        S = labels.shape[1]
        loss = cross_entropy(logits[:, -S:], labels)
        return loss + 0.01 * aux, {"ce": loss, "aux": aux}

    return loss_fn


def value_and_grad(loss_fn, params: Any, batch: dict):
    """(loss, metrics, grads): ``jax.value_and_grad(..., has_aux=True)`` of
    the reference. The grads tree has the params' structure; a leaf the
    loss does not read (a Mamba2 layer's unused ``ln2``) gets zeros."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = loss_fn(live, batch)
    grads = torch.autograd.grad(loss, leaves(live), allow_unused=True,
                                materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            from_leaves(params, grads))


def make_train_step(model, opt_cfg: adamw.AdamWConfig, remat: bool = True,
                    constrain=None):
    loss_fn = make_loss_fn(model, remat, constrain)

    def train_step(params, opt_state, batch):
        loss, metrics, grads = value_and_grad(loss_fn, params, batch)
        params, opt_state, opt_metrics = adamw.apply_updates(opt_cfg, params, grads,
                                                             opt_state)
        return params, opt_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def make_batch(cfg, raw: dict, device) -> dict:
    """A pipeline batch on ``device``, with the stub frontends' zero
    embeddings the family takes (reference ``train.py:100-111``)."""
    batch = raw["tokens"].shape[0]
    seq_len = raw["tokens"].shape[1]
    dtype = getattr(torch, cfg.dtype)
    b: dict[str, Any] = {"tokens": torch.from_numpy(raw["tokens"]).to(device),
                         "labels": torch.from_numpy(raw["labels"]).to(device)}
    if cfg.n_prefix_tokens:
        b["prefix_embeds"] = torch.zeros((batch, cfg.n_prefix_tokens, cfg.d_model),
                                         dtype=dtype, device=device)
    if cfg.family == "audio":
        b["frames"] = torch.zeros((batch, max(seq_len // cfg.enc_len_ratio, 1),
                                   cfg.d_model), dtype=dtype, device=device)
    return b


def run_training(
    arch: str,
    steps: int = 20,
    reduced: bool = True,
    seq_len: int = 128,
    batch: int = 4,
    log_every: int = 5,
    ckpt_path: str | None = None,
    save_every: int = 0,
    device=None,
    out: dict | None = None,
) -> list[dict[str, float]]:
    """The reference's ``run_training`` on ``device`` (default: the card).
    Returns one dict of floats per step run: loss, ce, aux, grad_norm, lr,
    wall_s. ``out``, if given, receives the final ``params`` and
    ``opt_state``."""
    device = resolve_device(device)
    cfg = get_reduced(arch) if reduced else get_config(arch)
    model = for_config(cfg, device)
    params = model.init(torch.Generator().manual_seed(0))
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=steps)
    opt_state = adamw.init_state(params)
    start_step = 0
    if ckpt_path and os.path.exists(ckpt_path + ".npz"):
        (params, opt_state), meta = ckpt.restore(ckpt_path, (params, opt_state))
        start_step = int(meta["step"])
        print(f"resumed from {ckpt_path} at step {start_step}")
    step_fn = make_train_step(model, opt_cfg, remat=False)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq_len, global_batch=batch))
    history = []
    for step in range(start_step, steps):
        b = make_batch(cfg, pipe.batch_at(step), device)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, b)
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics["wall_s"] = time.perf_counter() - t0
        history.append(metrics)
        if step % log_every == 0:
            print(f"step {step}: loss={metrics['loss']:.4f} "
                  f"gnorm={metrics['grad_norm']:.3f} {metrics['wall_s']:.2f}s")
        if ckpt_path and save_every and (step + 1) % save_every == 0:
            # exact resume: the pipeline is seekable by step, so saving
            # (params, opt_state, step) is the complete training state
            ckpt.save(ckpt_path, (params, opt_state), meta={"step": step + 1})
    if out is not None:
        out.update(params=params, opt_state=opt_state)
    return history


def main(argv=None) -> list[dict[str, float]]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--full", action="store_true", help="use the full config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint path: resume from PATH.npz if it exists")
    ap.add_argument("--save-every", type=int, default=0,
                    help="save to --ckpt every K steps (0: never)")
    args = ap.parse_args(argv)
    hist = run_training(
        args.arch, steps=args.steps, reduced=not args.full, seq_len=args.seq_len,
        batch=args.batch, ckpt_path=args.ckpt, save_every=args.save_every,
        device=args.device,
    )
    if hist:
        print(f"final loss: {hist[-1]['loss']:.4f} (first {hist[0]['loss']:.4f})")
    return hist


if __name__ == "__main__":
    main()

"""Tiny cells for the CPU tests: the harness, the engine and the
reference run end to end on the CPU at a size a test run holds."""

from __future__ import annotations

import contextlib

import torch

from perfbench import spec

M = {"mixer": "mamba", "ffn": "none"}
MS = {"mixer": "mamba", "ffn": "none", "shared_attn": True}

# the kernel's (head dim, group) pairs include (64, 3) and (64, 1)
TINY_ARCH = {
    "moe": {"name": "tiny-moe", "family": "moe", "d_model": 128, "n_heads": 6,
            "n_kv_heads": 2, "d_ff": 32, "vocab": 4096, "head_dim": 64,
            "act": "silu", "rope_theta": 10000.0, "rms_eps": 1e-6,
            "period": [{"mixer": "attn", "ffn": "moe"}], "n_periods": 2,
            "remainder": [], "n_experts": 40, "top_k": 8, "capacity_factor": 1.25,
            "dtype": "bfloat16"},
    "hybrid": {"name": "tiny-hybrid", "family": "hybrid", "d_model": 64,
               "n_heads": 4, "n_kv_heads": 4, "d_ff": 64, "vocab": 4096,
               "act": "gelu", "rope_theta": 10000.0, "rms_eps": 1e-5,
               "period": [M, MS], "n_periods": 2, "remainder": [M],
               "ssm_state": 16, "ssm_head_dim": 16, "ssm_expand": 2,
               "ssm_conv": 4, "ssm_groups": 2, "shared_attn_heads": 2,
               "supports_long_context": True, "dtype": "bfloat16"},
}

TINY_MIX = {
    "open": {"loop": "open", "rate_per_s": 8, "strata": 4,
             "prompt": {"dist": "lognormal", "median": 8, "sigma": 0.6, "min": 4,
                        "max": 24},
             "output": {"dist": "lognormal", "median": 8, "sigma": 0.6, "min": 4,
                        "max": 16},
             "n_slots": 4, "max_len": 64, "block_size": 8, "trace_seconds": 1},
    "closed": {"loop": "closed", "clients": 4, "stagger": True,
               "prompt": {"dist": "uniform", "min": 4, "max": 8},
               "output": {"dist": "uniform", "min": 8, "max": 16},
               "n_slots": 4, "max_len": 64, "block_size": 8, "trace_seconds": 1},
}


@contextlib.contextmanager
def one_thread():
    """Tiny ops gain nothing from threads, and test workers share the
    cores: one intra-op thread for the length of a run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def tiny_cell(arch: str, loop: str, *, like: str, limits: dict | None = None
              ) -> spec.Cell:
    """A tiny cell with the metrics of the real cell ``like``, and its
    correctness limits unless ``limits`` are given."""
    real = spec.cell(like)
    return spec.Cell(name=like, chips=1, config={"repro_arch": TINY_ARCH[arch]},
                     traffic=TINY_MIX[loop],
                     limits=real.limits if limits is None else limits,
                     end_to_end=real.end_to_end, per_layer=real.per_layer)

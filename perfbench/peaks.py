"""The yardstick's peaks and the ``flash_decode`` kernel's least time.

A frozen copy of ``src/repro_torch/launch/roofline.py`` (``Card``,
``_CARDS``, ``card``, ``flash_decode_flops`` and the ``flash_decode``
branch of ``kernel_bound``) and of the tensor-core table of
``src/repro_torch/kernels/smem_plan.py`` (``FD_TC_PAIRS``,
``flash_decode_path``), kept here so that a change to the program does
not move the benchmark's arithmetic. Published peaks of each card (NVIDIA
data sheets, dense rates, at the full power limit); an unknown card
raises.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Card:
    name: str
    hbm_bytes_per_s: float
    bf16_flops: float  # tensor cores, dense
    fp32_flops: float  # CUDA cores


_CARDS = (
    (lambda n: "H200" in n, Card("H200 SXM", 4.8e12, 989e12, 67e12)),
    (lambda n: "H100" in n and "NVL" in n, Card("H100 NVL", 3.9e12, 835e12, 60e12)),
    (lambda n: "H100" in n and "PCIe" in n, Card("H100 PCIe", 2.0e12, 756e12, 51e12)),
    (lambda n: "H100" in n, Card("H100 SXM", 3.35e12, 989e12, 67e12)),
)


def card(name: str) -> Card:
    for test, spec in _CARDS:
        if test(name):
            return spec
    raise ValueError(f"no published peaks known for the card {name!r}")


# (head dim, query heads per K/V head) that run on the tensor-core kernel
FD_TC_PAIRS = ((192, 12),)
_ITEMSIZE = {"float32": 4, "bfloat16": 2}


def flash_decode_path(D: int, G: int, dtype: str) -> str:
    return "tensor_core" if dtype == "bfloat16" and (D, G) in FD_TC_PAIRS else "cuda_core"


def flash_decode_bound_s(B: int, KV: int, G: int, D: int, sum_lengths: int,
                         dtype: str, spec: Card) -> float:
    """Least seconds of one call over ``B`` rows that read ``sum_lengths``
    positions in all: the K and V rows read once, q in and the output
    out, the lengths; 4·D FLOPs per (query head, position) at the rate
    of the units the kernel computes on."""
    item = _ITEMSIZE[dtype]
    nbytes = (sum_lengths * KV * D * 2 * item + 2 * B * KV * G * D * item + B * 4)
    flops = 4 * sum_lengths * KV * G * D
    rate = spec.bf16_flops if flash_decode_path(D, G, dtype) == "tensor_core" \
        else spec.fp32_flops
    return max(nbytes / spec.hbm_bytes_per_s, flops / rate)

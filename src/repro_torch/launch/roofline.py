"""Roofline of the port on the card: peaks, kernel bounds, step counts.

Twin of the reference's ``launch/roofline.py``, with the card's constants
in place of the TPU's. ``card(name)`` takes the name the card gives
(``torch.cuda.get_device_name`` or nvidia-smi) and returns its published
peaks; an unknown card raises. For an H100 SXM: 3.35 TB/s of HBM,
989 TFLOP/s dense bf16 on the tensor cores, 67 TFLOP/s fp32 on the CUDA
cores and 450 GB/s of NVLink each way (NVIDIA's data sheets; the rates
assume the card's full 700 W power limit).

Two counts read one model:

* ``step_count(trace, params, inputs, state=..., axes=..., lengths=...)``
  counts one traced step (an :class:`~repro_torch.trace.fx_liveness.FxTrace`):
  its FLOPs from ``torch.utils.flop_counter``'s formulas over the fx
  graph, with formulas registered here for the two custom ops that count
  the operations of PERF.md's kernel rows (the causal half for
  ``ssd_chunk``); and its ``min_bytes``, what any implementation of the
  step must move once: the parameters, the other inputs, the state read
  up to ``lengths`` (default: every position; a sliding-window ring,
  named by ``ring_windows``, up to its window), the state written, and
  the outputs that are not the state itself.
  ``bound_s = max(flops / peak_flops, min_bytes / peak_bandwidth)``;
* ``kernel_bound(kernel, shape, card=...)`` is the bound of one kernel
  call (each input read once, each output written once; operations at
  the rate of the units the kernel computes on), from the same formulas.

``Roofline`` is the reference's row of one sharded step
(``launch/dryrun.py``): per-device FLOPs, bytes and collective bytes
(``launch/fx_analysis.py``) over the card's peaks, with the collective
term at NVLink's published rate each way, a lower bound on the time: an
axis of 16 cards spans two 8-card NVLink nodes, whose link between them
is slower.

``count_params``, ``active_params`` and ``model_flops`` are the
reference's, for the model FLOPs utilisation (``mfu``); ``expert_bytes``
sizes a MoE layer's expert weights, all of them (what the one-hot
dispatch reads) or the routed ones only; ``shared_reread_bytes`` is
what zamba2's shared block adds when it is read at every insertion.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch
import torch.utils._pytree as pytree
from torch.utils.flop_counter import flop_registry, register_flop_formula

from repro_torch.core.unified import iter_leaves
from repro_torch.kernels import flash_decode as _flash_decode  # noqa: F401 (the op)
from repro_torch.kernels import ssd_chunk as _ssd_chunk  # noqa: F401 (the op)
from repro_torch.kernels.smem_plan import flash_decode_path


@dataclasses.dataclass(frozen=True)
class Card:
    """Published peaks of one card (dense rates, full power limit)."""

    name: str
    hbm_bytes_per_s: float
    bf16_flops: float  # tensor cores, dense
    fp32_flops: float  # CUDA cores
    nvlink_bytes_per_s: float  # each way

    @property
    def peak_flops(self) -> float:
        return self.bf16_flops


# (test on the card's name, its peaks), first match wins
_CARDS: tuple[tuple[Any, Card], ...] = (
    (lambda n: "H200" in n, Card("H200 SXM", 4.8e12, 989e12, 67e12, 450e9)),
    (lambda n: "H100" in n and "NVL" in n,
     Card("H100 NVL", 3.9e12, 835e12, 60e12, 300e9)),
    (lambda n: "H100" in n and "PCIe" in n,
     Card("H100 PCIe", 2.0e12, 756e12, 51e12, 300e9)),
    (lambda n: "H100" in n, Card("H100 SXM", 3.35e12, 989e12, 67e12, 450e9)),
)


def card(name: str) -> Card:
    """The peaks of the card ``name`` names; an unknown card raises."""
    for test, spec in _CARDS:
        if test(name):
            return spec
    raise ValueError(f"no published peaks known for the card {name!r}")


def peak_bandwidth(name: str) -> float:
    """Published HBM bandwidth (bytes/s) of the card ``name`` names."""
    return card(name).hbm_bytes_per_s


def peak_flops(name: str) -> float:
    """Published dense bf16 tensor-core rate (FLOP/s) of the card."""
    return card(name).peak_flops


# ------------------------------------------------- the custom ops' formulas


def flash_decode_flops(q_shape, k_shape, sum_lengths: int | None = None) -> int:
    """q·kᵀ and p·v of every query head over the positions read:
    4·D FLOPs per (query head, position). ``sum_lengths`` is the
    positions read over the batch (default: all ``B·T``)."""
    B, KV, G, D = q_shape
    T = k_shape[1]
    positions = B * T if sum_lengths is None else sum_lengths
    return 4 * positions * KV * G * D


def ssd_chunk_flops(x_shape, state_shape) -> int:
    """The causal half of C·Bᵀ and W·x (j ≤ i) plus C·stateᵀ and the new
    state's xᵀ·B, 2 FLOPs per multiply-add."""
    B, L, H, P = x_shape
    N = state_shape[-1]
    pairs = L * (L + 1) // 2
    return B * H * 2 * ((N + P) * pairs + 2 * L * P * N)


def ssd_chunk_bwd_flops(x_shape, state_shape) -> int:
    """The causal half of the backward's five L x L products (S = C·Bᵀ,
    dW = dy·xᵀ, Wᵀ·dy, dS·B, dSᵀ·C) plus its four L x P x N ones (B·dnsᵀ,
    x·dns, dy·state, dyᵀ·C), 2 FLOPs per multiply-add."""
    B, L, H, P = x_shape
    N = state_shape[-1]
    pairs = L * (L + 1) // 2
    return B * H * 2 * ((3 * N + 2 * P) * pairs + 4 * L * P * N)


def _register() -> None:
    fd = torch.ops.repro_torch.flash_decode
    sc = torch.ops.repro_torch.ssd_chunk
    if fd not in flop_registry:
        @register_flop_formula(fd)
        def _fd(q_shape, k_shape, v_shape, lengths_shape, *, out_shape=None, **kw):
            return flash_decode_flops(q_shape, k_shape)

    if sc not in flop_registry:
        @register_flop_formula(sc)
        def _sc(x_shape, dt_shape, da_shape, b_shape, c_shape, state_shape, *,
                out_shape=None, **kw):
            return ssd_chunk_flops(x_shape, state_shape)


_register()


# ------------------------------------------------------------- kernel bound


@dataclasses.dataclass(frozen=True)
class Bound:
    flops: int
    min_bytes: int
    flops_per_s: float  # the peak of the units the work runs on
    bytes_per_s: float

    @property
    def ops_s(self) -> float:
        return self.flops / self.flops_per_s

    @property
    def bytes_s(self) -> float:
        return self.min_bytes / self.bytes_per_s

    @property
    def bound_s(self) -> float:
        return max(self.ops_s, self.bytes_s)

    @property
    def bound_by(self) -> str:
        return "bytes" if self.bytes_s >= self.ops_s else "operations"


_ITEMSIZE = {"float32": 4, "bfloat16": 2}


def kernel_bound(kernel: str, shape: dict, *, card_name: str) -> Bound:
    """The least time the card could take for one call of ``kernel``.

    ``flash_decode``: ``shape`` has B, KV, G, D, T, dtype and optionally
    ``sum_lengths`` (positions read over the batch; default B·T): its
    arithmetic runs on the kernel the instantiation picks
    (``kernels/smem_plan.flash_decode_path``), the fp32 CUDA cores or the
    bf16 tensor cores. ``ssd_chunk``: B, L, H, P, N,
    dtype, state_dtype and ``groups`` (B and C are read once per group;
    default H); bf16 x/B/C run on the tensor cores, fp32 on the CUDA
    cores. ``ssd_chunk_bwd``: the same keys; it reads x, dt, dA, B, C
    (per group), the state, dy and dns once and writes dx, ddt, ddA, dB
    and dC (per head) and dstate once."""
    spec = card(card_name)
    if kernel == "flash_decode":
        B, KV, G, D, T = (shape[k] for k in ("B", "KV", "G", "D", "T"))
        item = _ITEMSIZE[shape["dtype"]]
        positions = shape.get("sum_lengths", B * T)
        nbytes = (positions * KV * D * 2 * item  # the K and V rows read
                  + 2 * B * KV * G * D * item    # q in, the output out
                  + B * 4)                       # lengths
        flops = flash_decode_flops((B, KV, G, D), (B, T, KV, D), positions)
        tensor_core = flash_decode_path(D, G, shape["dtype"]) == "tensor_core"
        rate = spec.bf16_flops if tensor_core else spec.fp32_flops
        return Bound(flops, nbytes, rate, spec.hbm_bytes_per_s)
    if kernel == "ssd_chunk":
        B, L, H, P, N = (shape[k] for k in ("B", "L", "H", "P", "N"))
        item = _ITEMSIZE[shape["dtype"]]
        s_item = _ITEMSIZE[shape.get("state_dtype", shape["dtype"])]
        groups = shape.get("groups", H)
        nbytes = (2 * B * L * H * P * item       # x in, y out
                  + 2 * B * L * H * 4            # dt, dA
                  + 2 * B * L * groups * N * item  # B, C
                  + 2 * B * H * P * N * s_item)  # state in, new state out
        flops = ssd_chunk_flops((B, L, H, P), (B, H, P, N))
        rate = spec.bf16_flops if shape["dtype"] == "bfloat16" else spec.fp32_flops
        return Bound(flops, nbytes, rate, spec.hbm_bytes_per_s)
    if kernel == "ssd_chunk_bwd":
        B, L, H, P, N = (shape[k] for k in ("B", "L", "H", "P", "N"))
        item = _ITEMSIZE[shape["dtype"]]
        s_item = _ITEMSIZE[shape.get("state_dtype", shape["dtype"])]
        groups = shape.get("groups", H)
        nbytes = (3 * B * L * H * P * item       # x, dy in, dx out
                  + 4 * B * L * H * 4            # dt, dA in, ddt, ddA out
                  + 2 * B * L * groups * N * item  # B, C in
                  + 2 * B * L * H * N * item     # dB, dC out, per head
                  + 3 * B * H * P * N * s_item)  # state, dns in, dstate out
        flops = ssd_chunk_bwd_flops((B, L, H, P), (B, H, P, N))
        rate = spec.bf16_flops if shape["dtype"] == "bfloat16" else spec.fp32_flops
        return Bound(flops, nbytes, rate, spec.hbm_bytes_per_s)
    raise ValueError(f"no bound for kernel {kernel!r}")


# --------------------------------------------------------------- step count


@dataclasses.dataclass(frozen=True)
class StepCount:
    flops: int
    param_bytes: int
    input_bytes: int
    state_read_bytes: int
    state_write_bytes: int
    output_bytes: int
    # FLOPs by op, for reading where they go
    flops_by_op: dict = dataclasses.field(default_factory=dict, compare=False)

    @property
    def min_bytes(self) -> int:
        return (self.param_bytes + self.input_bytes + self.state_read_bytes
                + self.state_write_bytes + self.output_bytes)

    def bound(self, card_name: str) -> Bound:
        spec = card(card_name)
        return Bound(self.flops, self.min_bytes, spec.peak_flops, spec.hbm_bytes_per_s)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensor_bytes(tree) -> int:
    return sum(_nbytes(x) for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor))


def _val(a):
    return a.meta.get("val") if isinstance(a, torch.fx.Node) else a


def ring_windows(cfg, state) -> dict[str, int]:
    """``path -> window`` of every sliding-window attention cache leaf of
    ``state`` (a cache structure of ``cfg``): the rings whose token axis
    ``detect_state_axes`` does not find once ``max_len >= window``."""
    rings: dict[str, int] = {}
    for part in ("period", "remainder"):
        for j, spec in enumerate(getattr(cfg, part)):
            if spec.mixer == "attn" and spec.window:
                for path, _ in iter_leaves(state[part][j], f"[{part!r}][{j}]"):
                    rings[path] = spec.window
    return rings


def step_count(
    trace,
    params,
    inputs=(),
    *,
    state=None,
    axes: dict[str, tuple[int, int | None]] | None = None,
    lengths: Sequence[int] | None = None,
    rings: dict[str, int] | None = None,
) -> StepCount:
    """Count one traced step (see the module docstring).

    ``params`` and ``inputs`` are the tensors (any pytree) the step reads
    whole; ``state`` the cache structure it reads and writes in place,
    with ``axes`` from :func:`~repro_torch.core.unified.detect_state_axes`.
    A state leaf with a token axis is read up to ``lengths[slot]``
    positions of each slot (default: all of them) and written one
    position per slot. A ring of ``rings`` (``ring_windows``; its token
    axis follows the slot axis) is read up to ``min(length, window)``
    positions of each slot — the least any implementation reads, where
    the plain attention reads the whole ring — and written one position
    per slot. Any other leaf without a token axis (Mamba2's conv window
    and SSM state) is read and written whole. ``flash_decode`` is counted
    over the same positions."""
    rings = rings or {}
    flops_by_op: dict[str, int] = {}
    fd = torch.ops.repro_torch.flash_decode
    for node in trace.gm.graph.nodes:
        if node.op != "call_function":
            continue
        packet = getattr(node.target, "overloadpacket", None)
        formula = flop_registry.get(packet)
        if formula is None:
            continue
        args, kwargs = pytree.tree_map(_val, (node.args, node.kwargs))
        if packet is fd and lengths is not None:
            q, k = args[0], args[1]
            T = k.shape[1]
            n = flash_decode_flops(tuple(q.shape), tuple(k.shape),
                                   sum(min(int(x), T) for x in lengths))
        else:
            n = int(formula(*args, out_val=node.meta.get("val"), **kwargs))
        key = str(packet)
        flops_by_op[key] = flops_by_op.get(key, 0) + n

    read = written = 0
    if state is not None:
        for path, leaf in iter_leaves(state):
            slot_ax, tok_ax = axes[path]
            nbytes = _nbytes(leaf)
            window = rings.get(path)
            if tok_ax is None and window is not None:
                n_slots, T = leaf.shape[slot_ax], leaf.shape[slot_ax + 1]
                row = nbytes // (n_slots * T)
                lens = [T] * n_slots if lengths is None else lengths
                read += row * sum(min(int(x), window, T) for x in lens)
                written += row * n_slots
                continue
            if tok_ax is None:
                read += nbytes
                written += nbytes
                continue
            n_slots, T = leaf.shape[slot_ax], leaf.shape[tok_ax]
            row = nbytes // (n_slots * T)  # one position of one slot
            lens = [T] * n_slots if lengths is None else lengths
            read += row * sum(min(int(x), T) for x in lens)
            written += row * n_slots

    # outputs that are not an input (the caches a decode step updates in
    # place are its inputs, counted above)
    placeholders = {trace.node_tid[n] for n in trace.gm.graph.nodes
                    if n.op == "placeholder" and isinstance(trace.node_tid.get(n), int)}
    out_node = next(n for n in trace.gm.graph.nodes if n.op == "output")
    out_bytes = 0
    seen: set[int] = set()
    for a in pytree.tree_leaves(out_node.args):
        tid = trace.node_tid.get(a) if isinstance(a, torch.fx.Node) else None
        if not isinstance(tid, int) or tid in placeholders or tid in seen:
            continue
        seen.add(tid)
        out_bytes += trace.graph.tensors[tid].nbytes
    return StepCount(
        flops=sum(flops_by_op.values()),
        param_bytes=_tensor_bytes(params),
        input_bytes=_tensor_bytes(inputs),
        state_read_bytes=read,
        state_write_bytes=written,
        output_bytes=out_bytes,
        flops_by_op=flops_by_op,
    )


# ------------------------------------------------- the reference's counts


@dataclasses.dataclass
class Roofline:
    """One sharded step on one device (reference ``roofline.py:105-157``):
    its terms at ``card_name``'s peaks, dense bf16 for the compute."""

    arch: str
    shape: str
    mesh: str
    flops: float  # per device
    bytes_accessed: float  # per device
    collective_bytes: float  # per device
    collectives: Any  # fx_analysis.GraphCost
    model_flops: float  # 6·N·D (or active-N) whole-step, per device share
    peak_memory_bytes: float  # per device: arguments + planned activations
    card_name: str = "H100 SXM"

    @property
    def compute_s(self) -> float:
        return self.flops / card(self.card_name).peak_flops

    @property
    def memory_s(self) -> float:
        return self.bytes_accessed / card(self.card_name).hbm_bytes_per_s

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / card(self.card_name).nvlink_bytes_per_s

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "hlo_gflops": self.flops / 1e9,
            "hbm_gb": self.bytes_accessed / 1e9,
            "coll_gb": self.collective_bytes / 1e9,
            "model_flops_ratio": self.useful_flops_ratio,
            "peak_mem_gb": self.peak_memory_bytes / 1e9,
        }


def count_params(cfg) -> int:
    """Parameter count from the config (analytic, no allocation)."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab
    hd = cfg.resolved_head_dim
    per_layer = 0
    n_attn = n_mamba = n_mlp = n_moe = n_shared_attn = 0
    for spec in list(cfg.period) * cfg.n_periods + list(cfg.remainder):
        if spec.mixer == "attn":
            n_attn += 1
        if spec.mixer == "mamba":
            n_mamba += 1
        if spec.ffn == "mlp":
            n_mlp += 1
        if spec.ffn == "moe":
            n_moe += 1
        if spec.shared_attn:
            n_shared_attn += 1
    attn_p = d * hd * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)
    gate = 0 if cfg.act == "sq_relu" else 1
    mlp_p = d * f * (2 + gate)
    total = v * d + n_attn * attn_p + n_mlp * mlp_p
    if n_moe:
        moe_p = cfg.n_experts * d * f * 3 + d * cfg.n_experts
        if cfg.shared_expert:
            moe_p += mlp_p
        total += n_moe * moe_p
    if n_mamba:
        from repro_torch.models.ssm import ssm_dims

        d_inner, nheads, conv_dim = ssm_dims(
            d, cfg.ssm_expand, cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state
        )
        proj_in = d * (2 * d_inner + 2 * cfg.ssm_groups * cfg.ssm_state + nheads)
        total += n_mamba * (proj_in + d_inner * d + cfg.ssm_conv * conv_dim)
    if n_shared_attn and cfg.shared_attn_heads:
        d2 = 2 * d
        total += d2 * d2 * 4 + d2 * f * 3 + d2 * d  # shared once
    if cfg.encoder_layers:
        total += cfg.encoder_layers * (attn_p + mlp_p)
        total += cfg.n_layers * attn_p  # decoder cross-attention
    return int(total)


def expert_bytes(cfg, experts: int | None = None) -> int:
    """Bytes of the expert stacks (``w_in``, ``w_gate``, ``w_out``) one
    MoE layer of ``cfg`` reads for ``experts`` distinct experts. The
    default is all of them: the one-hot dispatch of ``models/moe.py``
    reads every expert on every call, routed to or not, and
    ``step_count`` counts them so (they are parameters, read whole)."""
    n = cfg.n_experts if experts is None else experts
    return n * 3 * cfg.d_model * cfg.d_ff * _ITEMSIZE[cfg.dtype]


def shared_insertions(cfg) -> int:
    """The layers that apply zamba2's shared block (13 at full width)."""
    return sum(1 for s in (*cfg.period * cfg.n_periods, *cfg.remainder)
               if s.shared_attn)


def shared_reread_bytes(cfg, params) -> int:
    """What a step that reads the shared block's params at every
    insertion reads beyond ``step_count``'s parameters, each read once:
    the block's bytes at each of its other insertions (the block does not
    stay in L2 between them: 1.079 GB in bf16 at full width); 0 without
    a shared block."""
    block = params.get("shared_attn")
    if block is None:
        return 0
    return (shared_insertions(cfg) - 1) * _tensor_bytes(block)


def active_params(cfg) -> int:
    """Active params per token (MoE: top_k of n_experts)."""
    if not cfg.n_experts:
        return count_params(cfg)
    full = count_params(cfg)
    n_moe = sum(
        1 for s in list(cfg.period) * cfg.n_periods + list(cfg.remainder)
        if s.ffn == "moe"
    )
    expert_p = cfg.n_experts * cfg.d_model * cfg.d_ff * 3
    active_expert_p = cfg.top_k * cfg.d_model * cfg.d_ff * 3
    return int(full - n_moe * (expert_p - active_expert_p))


def model_flops(cfg, shape) -> float:
    """6·N·D for train, 2·N·D for inference forward (D = tokens)."""
    n = active_params(cfg) - cfg.vocab * cfg.d_model  # non-embedding
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        mult = 6.0
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        mult = 2.0
    else:  # decode: one token per sequence
        tokens = shape.global_batch
        mult = 2.0
    # embedding/unembedding matmul
    unemb = 2.0 * tokens * cfg.d_model * cfg.vocab * (3.0 if shape.kind == "train" else 1.0)
    return mult * n * tokens + unemb


def mfu(model_flops_: float, device_s: float, card_name: str) -> float:
    """Model FLOPs over what the card's dense bf16 peak does in ``device_s``."""
    return model_flops_ / (device_s * peak_flops(card_name))


__all__ = [
    "Bound", "Card", "Roofline", "StepCount", "active_params", "card", "count_params",
    "expert_bytes",
    "flash_decode_flops", "kernel_bound", "mfu", "model_flops", "peak_bandwidth",
    "peak_flops", "ring_windows", "shared_insertions", "shared_reread_bytes",
    "ssd_chunk_flops", "step_count",
]

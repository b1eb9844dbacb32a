"""Shared-memory budgeting for the Hopper kernels via the paper's planner.

Twin of the reference's ``kernels/vmem_plan.py``. One CTA of a Hopper
kernel is a micro-scale instance of the paper's problem: the kernel's
shared-memory tiles (a ring of K/V tiles, the C and state tiles, the
merge scratch that reuses the ring after the loop) are tensors with
usage intervals over the kernel's stages, and the block's shared memory
is the arena. ``plan_flash_decode_smem`` and ``plan_ssd_chunk_smem``
build the usage records of one CTA of ``csrc/flash_decode.cu`` and
``csrc/ssd_chunk.cu``, plan them with the port's planner (Offset
Calculation, Greedy by Size) and return the planned footprint beside the
budget. The sizes below mirror the constants of the two sources; on the
card ``chip_smoke.py`` holds each plan against the bytes the kernel
requests at launch (each source's exported ``*_smem_bytes`` query) and
against the device's opt-in limit.

Budget (NVIDIA H100): a block may use up to 227 KiB (232,448 B) of the
SM's 256 KiB of shared memory and L1, above 48 KiB only as dynamic
shared memory after an opt-in.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from repro_torch.core.planner import MemoryPlan

# The planner is imported where the records are planned, not here:
# ``core/fusion_search`` reads its default budget from this module, and
# importing ``repro_torch.core`` imports fusion_search.

SMEM_BYTES = 232_448  # the most one block can use (opt-in above 48 KiB)
SM_SHARED_L1_BYTES = 256 * 2**10  # one SM's shared memory and L1 together

# What a FUSED kernel's internalized tensors may occupy: the block's
# shared memory less the working set the planned kernel steps keep
# resident. The largest planned step of any instantiation is ssd_chunk's
# tensor-core CTA with an fp32 state at P=64, N=128 (107 KiB; tests hold
# every instantiation under the reserve).
SMEM_PIPELINE_RESERVE_BYTES = 112 * 2**10

# cp.async and ldmatrix move 16-byte chunks: every tile starts 16-aligned
_ALIGN = 16

# csrc/flash_decode.cu: 4 warps; a ring of kStages tiles of K and V rows,
# kUnroll positions per lane group per tile; the merge of up to kMaxSplits
# partials; the (D, G) pairs it builds (FD_PAIRS). The pairs whose bf16
# instantiations run on the tensor-core kernel (FD_TC_PAIRS, the one Python
# copy of the source's table; kernels/flash_decode.kernel_path reads it): a
# ring of kTcStages tiles of kTcRows positions per warp
FD_WARPS = 4
FD_UNROLL = 2
FD_STAGES = 4
FD_MAX_SPLITS = 64
FD_PAIRS = ((64, 1), (64, 2), (64, 3), (64, 4), (64, 7), (64, 8), (128, 1),
            (128, 2), (128, 4), (128, 5), (128, 8), (168, 2), (192, 12),
            (224, 1), (320, 2))
FD_TC_PAIRS = ((192, 12),)
FD_TC_STAGES = 2
FD_TC_ROWS = 16

# csrc/ssd_chunk.cu: chunks of at most kMaxL positions, N <= kMaxN; the
# tensor-core kernel (bf16 x/B/C) has 4 warps and 64-row tiles, the
# CUDA-core kernel (fp32 x/B/C) 8 warps, 64-row tiles and a W tile of
# rows of kTileJ + 4 floats
SSD_MAX_L = 256
SSD_MAX_N = 128
SSD_HEAD_DIMS = (8, 32, 64)
SSD_TC_WARPS = 4
SSD_TC_TILE = 64
SSD_FP32_WARPS = 8
SSD_FP32_TILE = 64
SSD_FP32_LDW = SSD_FP32_TILE + 4

# csrc/ssd_chunk_bwd.cu: the tensor-core kernel (bf16 x/B/C) has 4 warps
# and bf16 64-row tiles as the forward's; the CUDA-core kernel (fp32
# x/B/C) 8 warps (one chunk position per thread in the scans), 64-row
# fp32 tiles, the W, dS and H tiles with rows of kTile + 1 floats
SSD_BWD_WARPS = 8
SSD_BWD_TILE = 64
SSD_BWD_LDT = SSD_BWD_TILE + 1

_ITEMSIZE = {"float32": 4, "bfloat16": 2}


def fusion_scratch_budget(
    smem_bytes: int = SMEM_BYTES,
    reserve_bytes: int = SMEM_PIPELINE_RESERVE_BYTES,
) -> int:
    """Kernel-local scratch available to fusion (``core/fusion_search``)."""
    return max(smem_bytes - reserve_bytes, 0)


@dataclasses.dataclass
class KernelSmemPlan:
    plan: "MemoryPlan"
    fits: bool
    budget: int = SMEM_BYTES

    def summary(self) -> str:
        return (
            f"{self.plan.graph_name}: {self.plan.total_size} B "
            f"of {self.budget} B shared memory "
            f"({'fits' if self.fits else 'OVER BUDGET'}; "
            f"naive co-residency {self.plan.naive_size} B"
            f"{'; cached plan' if self.plan.cache_hit else ''})"
        )


class _Records:
    def __init__(self) -> None:
        self.recs: list = []

    def add(self, first: int, last: int, nbytes: int) -> None:
        from repro_torch.core.records import TensorUsageRecord, align

        self.recs.append(TensorUsageRecord(
            first, last, align(max(nbytes, 1), _ALIGN), tensor_id=len(self.recs)))

    def plan(self, name: str) -> KernelSmemPlan:
        from repro_torch.core.planner import plan_records

        plan = plan_records(self.recs, mode="offsets", strategy="greedy_by_size",
                            graph_name=name)
        return KernelSmemPlan(plan=plan, fits=plan.total_size <= SMEM_BYTES)


def _check_dtype(dtype: str) -> None:
    if dtype not in _ITEMSIZE:
        raise ValueError(f"dtype {dtype!r}: one of {sorted(_ITEMSIZE)}")


def flash_decode_path(D: int, G: int, dtype: str) -> str:
    """The kernel ``(dtype, D, G)`` runs on: ``"tensor_core"`` for bf16 at
    a pair of ``FD_TC_PAIRS``, else ``"cuda_core"``."""
    return "tensor_core" if dtype == "bfloat16" and (D, G) in FD_TC_PAIRS else "cuda_core"


def flash_decode_tile(D: int, G: int, dtype: str) -> tuple[int, int]:
    """``(positions per tile, 16-byte chunks per cache row)`` of one
    ``flash_decode`` CTA of the instantiation ``(dtype, D, G)``, on the
    kernel it runs on (``flash_decode_path``). CUDA cores (``Layout`` of
    ``csrc/flash_decode.cu``): a row is CH chunks; where CH divides 32 a
    position takes CH lanes, else a whole warp. Tensor cores
    (``TcLayout``): ``FD_TC_ROWS`` positions for each warp."""
    ch = D * _ITEMSIZE[dtype] // 16
    if flash_decode_path(D, G, dtype) == "tensor_core":
        return FD_WARPS * FD_TC_ROWS, ch
    lanes = ch if ch <= 32 and 32 % ch == 0 else 32
    return FD_WARPS * (32 // lanes) * FD_UNROLL, ch


def plan_flash_decode_smem(
    *, G: int, D: int, dtype: str = "bfloat16", stages: int | None = None
) -> KernelSmemPlan:
    """One CTA of ``flash_decode`` (one span of one ``(b, kv_head)``) on
    the kernel the instantiation runs on (``flash_decode_path``), with
    ``stages`` ring slots (default the kernel's: ``FD_STAGES``,
    ``FD_TC_STAGES`` on the tensor cores).

    Stages (ops): 0 prologue, the first ``stages - 1`` tiles in flight |
    1 the span's loop over the whole ring | 2 the merge of the warps'
    (m, l, acc) | 3 the merge of the spans' partials by the last CTA.
    A ring slot holds the K rows and the V rows of one tile
    (``flash_decode_tile``): 8 KiB where a row's chunks divide a warp
    (D = 64, 128), ``2 · 8 · D · itemsize`` bytes where a warp reads one
    position (bf16 D = 320: 10 KiB), ``2 · 64 · D · 2`` on the tensor
    cores (bf16 D = 192: 48 KiB). The two merges reuse the ring.
    """
    _check_dtype(dtype)
    if (D, G) not in FD_PAIRS:
        raise ValueError(f"flash_decode is built for (D, G) in {FD_PAIRS}; "
                         f"got D={D}, G={G}")
    tensor_core = flash_decode_path(D, G, dtype) == "tensor_core"
    if stages is None:
        stages = FD_TC_STAGES if tensor_core else FD_STAGES
    tile, ch = flash_decode_tile(D, G, dtype)
    half_tile = tile * ch * 16  # the K (or V) rows of one tile
    r = _Records()
    for s in range(stages):
        first = 0 if s < stages - 1 else 1
        r.add(first, 1, half_tile)  # K rows of ring slot s
        r.add(first, 1, half_tile)  # V rows of ring slot s
    r.add(2, 2, FD_WARPS * G * 4)      # each warp's running max m
    r.add(2, 2, FD_WARPS * G * 4)      # each warp's running sum l
    r.add(2, 2, FD_WARPS * G * D * 4)  # each warp's accumulator
    r.add(3, 3, FD_MAX_SPLITS * G * 4)  # the spans' m, then their weights
    r.add(3, 3, FD_MAX_SPLITS * G * 4)  # the spans' l
    r.add(3, 3, G * 4)                  # 1 / (sum of weighted l)
    kind = ",tensor_core" if tensor_core else ""
    return r.plan(f"flash_decode[G={G},D={D},{dtype},stages={stages}{kind}]")


def plan_ssd_chunk_smem(
    *, P: int, N: int, dtype: str = "bfloat16", state_dtype: str | None = None
) -> KernelSmemPlan:
    """One CTA of ``ssd_chunk`` at head dim ``P`` and ``N`` state columns,
    for x/B/C of ``dtype`` (bf16: the tensor-core kernel, fp32: the
    CUDA-core kernel) and a state of ``state_dtype`` (default ``dtype``).

    Stages (ops), tensor-core kernel: 0 the prologue (the first copies of
    C, the state and key tile 0 fly while the float64 prefix sum runs) |
    1 the passes over the CTA's row tiles (C·stateᵀ, then the key tiles
    through a two-stage ring). CUDA-core kernel: 0 the prefix sum | 1 the
    key loop | 2 C·stateᵀ, with the state in the B tile's place. The
    working set is a y CTA's; a state CTA uses a subset of it.
    """
    _check_dtype(dtype)
    state_dtype = dtype if state_dtype is None else state_dtype
    _check_dtype(state_dtype)
    if P not in SSD_HEAD_DIMS or not 1 <= N <= SSD_MAX_N:
        raise ValueError(f"ssd_chunk is built for P in {SSD_HEAD_DIMS}, "
                         f"1 <= N <= {SSD_MAX_N}; got P={P}, N={N}")
    r = _Records()
    L = SSD_MAX_L
    if dtype == "bfloat16":
        T = SSD_TC_TILE
        npad = -(-N // 16) * 16
        ldc, ldx = npad + 8, P + 8  # bf16 rows padded by 8 elements
        r.add(0, 1, 8 * L)                 # cum, float64
        r.add(0, 0, 8 * SSD_TC_WARPS)      # the warps' scan totals
        r.add(0, 1, 4 * L)                 # dt
        r.add(1, 1, 4 * L)                 # the column decays exp(cum_i0 - cum_j) dt_j
        r.add(0, 1, 2 * T * ldc)           # the C tile
        if state_dtype == "bfloat16":
            r.add(0, 1, 2 * T * ldc)       # the state, bf16 [64][ldc]
        else:
            r.add(0, 1, 4 * P * (npad + 8))  # the state, fp32 [P][npad + 8]
        for _stage in range(2):
            r.add(0, 1, 2 * T * ldc)       # B rows of a key tile
            r.add(0, 1, 2 * T * ldx)       # x rows of a key tile
    else:
        T = SSD_FP32_TILE
        n4 = -(-N // 4) * 4
        ldn = n4 if (n4 // 4) % 2 else n4 + 4  # an odd number of float4 per row
        r.add(0, 2, 8 * L)                   # cum, float64
        r.add(0, 0, 8 * SSD_FP32_WARPS)      # the warps' scan totals
        r.add(0, 1, 4 * L)                   # dt
        r.add(1, 2, 4 * T * ldn)             # the C tile
        r.add(1, 1, 4 * T * ldn)             # the B tile
        r.add(1, 1, 4 * T * P)               # the x tile
        r.add(1, 1, 4 * T * SSD_FP32_LDW)    # the W tile
        r.add(2, 2, 4 * P * ldn)             # the incoming state
    return r.plan(f"ssd_chunk[P={P},N={N},{dtype},state={state_dtype}]")


def _fp32_row_stride(n: int) -> int:
    """``row_stride`` of the fp32 SSD kernels: n padded to a multiple of 4
    floats, then to an odd number of float4s."""
    n4 = -(-n // 4) * 4
    return n4 if (n4 // 4) % 2 else n4 + 4


def plan_ssd_chunk_bwd_smem(
    *, P: int, N: int, dtype: str = "bfloat16", state_dtype: str | None = None
) -> KernelSmemPlan:
    """One CTA of ``ssd_chunk_bwd`` at head dim ``P`` and ``N`` state
    columns, for x/B/C of ``dtype`` (bf16: the tensor-core kernel, fp32:
    the CUDA-core kernel) and a state and dns of ``state_dtype`` (default
    ``dtype``).

    Tensor-core kernel (one layout for its key, row and dstate CTAs; the
    working set is a key or row CTA's), stages (ops): 0 the prologue (the
    first copies fly while the float64 prefix sum runs) | 1 the loop over
    the ring | 2 the tails (the dns terms, the outputs) | 3 the last CTA's
    reduction (dcum over cum's place, the reverse sum).

    CUDA-core kernel (its tiles fp32 whatever the state's dtype): 0 the
    float64 prefix sum and the per-position arrays | 1 pass 1's row loop
    (key tile B, x; row tile C, dy; W, dS, H) | 2 pass 1's tail (dns and
    dnsᵀ in the row tile's place) | 3 pass 2's key loop (row tile C, dy;
    key tile; dS, H) | 4 pass 2's tail (the state in the key tile's place)
    | 5 dtotal and the float64 reverse sum."""
    _check_dtype(dtype)
    state_dtype = dtype if state_dtype is None else state_dtype
    _check_dtype(state_dtype)
    if P not in SSD_HEAD_DIMS or not 1 <= N <= SSD_MAX_N:
        raise ValueError(f"ssd_chunk_bwd is built for P in {SSD_HEAD_DIMS}, "
                         f"1 <= N <= {SSD_MAX_N}; got P={P}, N={N}")
    L, T = SSD_MAX_L, SSD_BWD_TILE
    r = _Records()
    if dtype == "bfloat16":
        npad = -(-N // 16) * 16
        pp = -(-P // 16) * 16
        ldc, ldx = npad + 8, pp + 8  # bf16 rows padded by 8 elements
        pair = 2 * T * ldc + 2 * T * ldx  # a tile of B or C rows and one of x or dy
        r.add(0, 3, 8 * L)                 # cum, float64, then dcum
        r.add(0, 3, 8 * SSD_TC_WARPS)      # the warps' scan and reduction totals
        r.add(0, 2, 4 * L)                 # dt
        r.add(0, 2, 4 * L)                 # exp(cum_l - cum_l0), l0 the first row of l's tile
        r.add(1, 2, 4 * L)                 # a row CTA's exp(cum_I0 - cum_j) dt_j
        r.add(3, 3, 4)                     # the arrival flag
        r.add(0, 2, pair)                  # the CTA's own tile pair
        r.add(0, 1, pair)                  # the ring's first stage
        r.add(1, 1, pair)                  # its second stage
        if state_dtype == "bfloat16":
            r.add(0, 2, 2 * T * ldc)       # the state or dns, bf16 [64][ldc]
        else:
            r.add(0, 2, 4 * pp * (npad + 4))  # the state or dns, fp32 [pad16(P)][npad + 4]
        return r.plan(f"ssd_chunk_bwd[P={P},N={N},{dtype},state={state_dtype}]")
    ldn, ldp = _fp32_row_stride(N), _fp32_row_stride(P)
    r.add(0, 4, 8 * L)                 # cum, float64
    r.add(0, 5, 8 * SSD_BWD_WARPS)     # the warps' scan totals
    r.add(0, 4, 4 * L)                 # dt
    r.add(0, 4, 4 * L)                 # exp(cum)
    r.add(2, 5, 8 * L)                 # dcum, float64
    r.add(2, 5, 4 * L)                 # drem_j rem_j, summed into dtotal
    r.add(2, 2, 4 * T)                 # drem of the key tile
    r.add(4, 4, 4 * T)                 # exp(cum_i) dy_i . (C_i stateᵀ) of the row tile
    r.add(1, 3, 4 * T * ldn)           # B rows of the key tile
    r.add(1, 3, 4 * T * ldp)           # x rows of the key tile
    # pass 1: the row tile's C rows, then dns in their place; its dy rows
    # and the W, dS and H tiles, then dnsᵀ in their place
    r.add(1, 2, 4 * T * ldn)
    r.add(1, 2, 4 * max(T * ldp + 3 * T * SSD_BWD_LDT, N * ldp))
    # pass 2: C and dy rows of the row tile, its dS and H tiles
    r.add(3, 4, 4 * T * ldn)
    r.add(3, 4, 4 * T * ldp)
    r.add(3, 3, 4 * T * SSD_BWD_LDT)
    r.add(3, 3, 4 * T * SSD_BWD_LDT)
    r.add(4, 4, 4 * P * ldn)           # the incoming state
    return r.plan(f"ssd_chunk_bwd[P={P},N={N},{dtype},state={state_dtype}]")

"""``repro_torch::flash_decode``: single-token GQA attention over a KV cache.

Replaces the Pallas TPU kernel ``flash_decode`` of
``src/repro/kernels/flash_decode.py`` (body ``_kernel``). The op is a
``torch.library`` custom op:

* CUDA: the hand-written Hopper kernel ``csrc/flash_decode.cu`` (built
  for ``sm_90a`` at first use, see ``kernels/build.py``). A tensor on the
  card never reaches the plain version: a build or launch failure raises;
* CPU: the plain ``kernels/ref.flash_decode_ref``;
* fake: shape and dtype only, so ``make_fx`` traces the op as ONE node,
  as a ``pallas_call`` is one jaxpr equation.

Layout: q ``(B, KV, G, D)`` contiguous; k/v cache ``(B, T, KV, D)`` with
any batch, position and head strides and a contiguous head dimension —
the cache is a view into the engine's state buffer, whose batch stride
is the state plan's slot stride, and it is never copied to make it
contiguous. lengths ``(B,)`` int32, read on the device, each >= 1.

Two kernels of ``csrc/flash_decode.cu`` compute it, picked from the
shapes by one table (the source's ``FD_TC_PAIRS``, copied in
``smem_plan.FD_TC_PAIRS``): bf16
at nemotron's (192, 12) runs on the tensor cores (the query heads as the
M rows of ``mma.sync``; P rounded to bf16 before P·V), every other pair
and every fp32 call on the CUDA cores (``kernel_path``).

On the card the positions of each ``(b, kv_head)`` are split into
``num_splits(B, KV, G, D, T, dtype)`` spans, one CTA each, and the last
CTA of each ``(b, kv_head)`` merges their partial softmax states
(flash-decoding). The split count comes from the shapes and the dtype
only, so the grid never depends on ``lengths``. The wrapper allocates the fp32 partials (``scratch_bytes``)
with ``torch.empty`` on every call, and keeps one int32 count per
``(b, kv_head)`` for each device and stream, which the kernel leaves at
0; the op has no input for either, so a traced plan does not see them.
Calls on two streams use two sets of counts, so they may overlap. Under
CUDA graph capture the scratch comes from the graph's pool, and the
counts must exist before the capture begins (``_counters``): graphs
captured on one stream share that stream's counts, so they are replayed
one at a time.

``repro_torch::flash_decode_paged`` computes the same function on a
cache held in a page pool (ROADMAP B1.4): ``buf`` is the pool viewed as
the cache dtype, row b of ``table`` (int32, ``(B, pages_per_slot)``)
maps slot b's logical region page by page (0: the pool's all-zero null
page), and the layer's K and V are the region's elements ``offset +
t·pos_stride + h·head_stride + d``. On the card it is the same kernel
with its loads translated through the table (the template flag
``PAGED`` of ``csrc/flash_decode.cu``), so it is bit-equal to
``flash_decode`` on the cache gathered out of the pool. On the CPU it is
``kernels/ref.flash_decode_paged_ref``, which gathers and calls
``flash_decode_ref``.

``repro_torch::flash_decode_lse`` is the same kernel returning, beside
the output, each query head's log-sum-exp of its scores over ``[0,
lengths[b])`` in fp32 ``(B, KV, G)`` (the merging CTA writes it from its
(m, l)); a row with no position gives the output 0 and -1e30, so
``lengths`` may be 0 there. On the CPU it is
``kernels/ref.flash_decode_lse_ref``.

Under sharding (a step on DTensors, ``launch/mesh.py``) ``flash_decode``
has a sharding rule of its own (``_sharding``): batch on the batch axes,
the KV heads on ``model``, or every input replicated; each rank launches
the kernel on its shard. A cache whose T is split over ranks (context
parallel) needs the ranks' softmaxes merged, which no placement of one
op gives: there the model calls ``flash_decode_lse`` on each rank's span
and merges the ranks' outputs by their log-sum-exps
(``models/attention.flash_decode_context_parallel``).

``LAUNCHES`` and ``PAGED_LAUNCHES`` count kernel launches (the CUDA path
only), one per call of each op (``flash_decode_lse`` counts in
``LAUNCHES``: it is the same kernel). A call under CUDA graph capture
launches nothing: ``runtime/graphs.py`` takes it off the count and adds
the graph's launches at each replay.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, smem_plan
from repro_torch.kernels.ref import (flash_decode_lse_ref, flash_decode_paged_ref,
                                     flash_decode_ref)

LAUNCHES = 0
PAGED_LAUNCHES = 0

# the (head_dim, group size) pairs csrc/flash_decode.cu builds (FD_PAIRS),
# each in fp32 and bf16: the powers of two at D = 64 and 128 (qwen3: 64, 2),
# granite-moe (64, 3), gemma3-4b's global layers (320, 2), gemma3-27b's
# (168, 2), internvl2 (64, 7), zamba2 (224, 1), llama4 (128, 5) and
# nemotron (192, 12)
PAIRS = frozenset({(64, 1), (64, 2), (64, 3), (64, 4), (64, 7), (64, 8),
                   (128, 1), (128, 2), (128, 4), (128, 5), (128, 8),
                   (168, 2), (192, 12), (224, 1), (320, 2)})
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# split T until there are at least two CTAs per SM of an H100 (132 SMs),
# keeping every span at least MIN_SPAN positions long; on the tensor-core
# kernel (two CTAs an SM, __launch_bounds__(128, 2)) split T only as far as
# one wave of TARGET_CTAS
TARGET_CTAS = 264
MIN_SPAN = 128
MAX_SPLITS = 64  # kMaxSplits of csrc/flash_decode.cu

_FN = None
_PAGED_FN = None
# (device, stream handle) -> int32 counts of finished spans
_COUNTERS: dict[tuple[torch.device, int], torch.Tensor] = {}
# counts replaced by larger ones: a graph captured with them still uses them
_RETIRED: list[torch.Tensor] = []


def smem_request_bytes(G: int, D: int, dtype: torch.dtype) -> int:
    """Bytes of dynamic shared memory one CTA of the instantiation
    ``(dtype, D, G)`` requests at launch, as ``csrc/flash_decode.cu``
    reports them (``flash_decode_smem_bytes``); builds the library."""
    fn = build.load("flash_decode").flash_decode_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    n = fn(_DTYPE_CODE[dtype], D, G)
    if n <= 0:
        raise ValueError(f"flash_decode has no instantiation for {dtype}, D={D}, G={G}")
    return n


def kernel_path(dtype: torch.dtype, D: int, G: int) -> str:
    """``"tensor_core"`` where the instantiation ``(dtype, D, G)`` runs on
    the tensor-core kernel (bf16 at a pair of the source's
    ``FD_TC_PAIRS``: ``smem_plan.flash_decode_path``), else
    ``"cuda_core"``; fp32 stays on the CUDA cores, whose 1e-5 bar leaves
    no room for a bf16 P."""
    return smem_plan.flash_decode_path(D, G, str(dtype).removeprefix("torch."))


def reported_path(G: int, D: int, dtype: torch.dtype) -> str:
    """The kernel the built library launches for ``(dtype, D, G)``, as
    ``csrc/flash_decode.cu`` reports it (``flash_decode_tensor_core``);
    builds the library."""
    fn = build.load("flash_decode").flash_decode_tensor_core
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    n = fn(_DTYPE_CODE[dtype], D, G)
    if n < 0:
        raise ValueError(f"flash_decode has no instantiation for {dtype}, D={D}, G={G}")
    return "tensor_core" if n else "cuda_core"


def ctas_per_sm(G: int, D: int, dtype: torch.dtype) -> int:
    """CTAs of the symmetric instantiation ``(dtype, D, G)`` that one SM
    holds at once (the occupancy API); needs the card."""
    fn = build.load("flash_decode").flash_decode_ctas_per_sm
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    n = fn(_DTYPE_CODE[dtype], D, G)
    if n <= 0:
        raise RuntimeError(f"flash_decode: no occupancy for {dtype}, D={D}, G={G} ({n})")
    return n


def _kernel():
    global _FN
    if _FN is None:
        fn = build.load("flash_decode").flash_decode_launch
        fn.argtypes = (
            [ctypes.c_int] * 7
            + [ctypes.c_void_p] * 8
            + [ctypes.c_int64] * 6
            + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _paged_kernel():
    global _PAGED_FN
    if _PAGED_FN is None:
        fn = build.load("flash_decode").flash_decode_paged_launch
        fn.argtypes = (
            [ctypes.c_int] * 7
            + [ctypes.c_void_p] * 7
            + [ctypes.c_int]
            + [ctypes.c_int64] * 5
            + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _PAGED_FN = fn
    return _PAGED_FN


def num_splits(batch: int, n_kv: int, group: int, head_dim: int, t_len: int,
               dtype: torch.dtype) -> int:
    """Spans per ``(b, kv_head)``, from the shapes and the dtype only, on
    the kernel they pick (``kernel_path``). CUDA cores: the least power of
    two that gives ``TARGET_CTAS`` CTAs; (8, 8, 2048), the qwen3 serving
    shape, gives 8 spans of 256. Tensor cores: the most, a power of two,
    that keeps the CTAs within one wave of ``TARGET_CTAS``; nemotron's
    span (8, 8, 2048) gives 4 of 512. Either at most ``t_len // MIN_SPAN``
    and ``MAX_SPLITS``, at least 1."""
    rows = max(batch * n_kv, 1)
    n = 1
    if kernel_path(dtype, head_dim, group) == "tensor_core":
        while 2 * n * rows <= TARGET_CTAS:
            n *= 2
    else:
        while n * rows < TARGET_CTAS:
            n *= 2
    return max(1, min(n, t_len // MIN_SPAN, MAX_SPLITS))


def scratch_bytes(batch: int, n_kv: int, group: int, head_dim: int,
                  t_len: int, dtype: torch.dtype) -> int:
    """Bytes of the fp32 partials (m, l, acc) one call allocates."""
    return (batch * n_kv * num_splits(batch, n_kv, group, head_dim, t_len, dtype)
            * group * (head_dim + 2) * 4)


def check_inputs(q, k_cache, v_cache, lengths) -> None:
    """What the kernel takes; raises ``ValueError`` on anything else."""
    if q.dim() != 4 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"flash_decode: q {tuple(q.shape)} must be (B,KV,G,D) and k/v "
            f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)} equal (B,T,KV,D)"
        )
    B, KV, G, D = q.shape
    if (k_cache.shape[0], k_cache.shape[2], k_cache.shape[3]) != (B, KV, D):
        raise ValueError(
            f"flash_decode: cache {tuple(k_cache.shape)} does not match q "
            f"{tuple(q.shape)}"
        )
    if lengths.shape != (B,) or lengths.dtype != torch.int32:
        raise ValueError("flash_decode: lengths must be int32 of shape (B,)")
    if not (q.dtype == k_cache.dtype == v_cache.dtype) or q.dtype not in _DTYPE_CODE:
        raise ValueError(
            f"flash_decode: dtypes {q.dtype}/{k_cache.dtype}/{v_cache.dtype}; "
            f"one of float32, bfloat16 expected"
        )
    if (D, G) not in PAIRS:
        raise ValueError(
            f"flash_decode: (head_dim, group size) ({D}, {G}) is not built; "
            f"the kernel is built for {sorted(PAIRS)}"
        )


def check_paged_inputs(q, buf, table, k_offset, v_offset, pos_stride,
                       head_stride, t_len, page_elems, lengths) -> None:
    """What the paged op takes; raises ``ValueError`` on anything else."""
    if q.dim() != 4 or buf.dim() != 1 or table.dim() != 2:
        raise ValueError(
            f"flash_decode_paged: q {tuple(q.shape)} must be (B,KV,G,D), buf "
            f"1-D and table (B, pages_per_slot); got {tuple(buf.shape)}, "
            f"{tuple(table.shape)}"
        )
    B, KV, G, D = q.shape
    if table.shape[0] != B or table.dtype != torch.int32:
        raise ValueError(f"flash_decode_paged: table must be int32 with {B} rows")
    if lengths.shape != (B,) or lengths.dtype != torch.int32:
        raise ValueError("flash_decode_paged: lengths must be int32 of shape (B,)")
    if q.dtype != buf.dtype or q.dtype not in _DTYPE_CODE:
        raise ValueError(
            f"flash_decode_paged: dtypes {q.dtype}/{buf.dtype}; one of "
            f"float32, bfloat16 expected for both"
        )
    if (D, G) not in PAIRS:
        raise ValueError(
            f"flash_decode_paged: (head_dim, group size) ({D}, {G}) is not "
            f"built; the kernel is built for {sorted(PAIRS)}"
        )
    if min(k_offset, v_offset, t_len) < 0 or page_elems < 1:
        raise ValueError("flash_decode_paged: negative offset, length or page")
    # the last element either cache reads must lie in the table's region
    last = max(k_offset, v_offset) + (t_len - 1) * pos_stride \
        + (KV - 1) * head_stride + D
    if t_len and last > table.shape[1] * page_elems:
        raise ValueError(
            f"flash_decode_paged: the caches reach element {last} of a slot "
            f"region of {table.shape[1]} pages of {page_elems}"
        )


def _check_cuda_layout(q, k_cache, v_cache, lengths) -> None:
    vec = 16 // q.element_size()  # elements per 16-byte load
    if not q.is_contiguous():
        raise ValueError("flash_decode: q must be contiguous")
    for name, c in (("k_cache", k_cache), ("v_cache", v_cache)):
        if c.stride(3) != 1 or any(c.stride(i) % vec for i in range(3)):
            raise ValueError(
                f"flash_decode: {name} strides {c.stride()} must keep the "
                f"head dimension contiguous and 16-byte aligned rows"
            )
    for t in (q, k_cache, v_cache):
        if t.data_ptr() % 16:
            raise ValueError("flash_decode: tensors must be 16-byte aligned")
    dev = q.device
    if any(t.device != dev for t in (k_cache, v_cache, lengths)):
        raise ValueError("flash_decode: all inputs must be on one device")


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The int32 counts of finished spans of one stream on ``device``, at
    least ``n``; zero when made, and every call leaves them at zero. Each
    stream has its own, so the kernels of two streams never share one.

    They are never made while a CUDA graph is captured on the stream:
    made then, they would come from that graph's private pool (and their
    zero fill would be captured), while every later graph captured on
    the same stream would point at them too and outlive the first. A
    capture must follow a warm-up call on its stream, which makes them
    from the allocator's ordinary memory. Counts that larger ones
    replace are kept alive, since a graph captured with them reads them
    at every replay."""
    key = (device, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "flash_decode: the stream being captured has no counts of "
                f"{n} spans yet; run the step once on that stream before "
                "capturing it"
            )
        if buf is not None:
            _RETIRED.append(buf)
        buf = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf


def _flash_decode_cuda(q, k_cache, v_cache, lengths):
    return _launch(q, k_cache, v_cache, lengths, None)


def _flash_decode_lse_cuda(q, k_cache, v_cache, lengths):
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    return _launch(q, k_cache, v_cache, lengths, lse), lse


def _launch(q, k_cache, v_cache, lengths, lse):
    global LAUNCHES
    check_inputs(q, k_cache, v_cache, lengths)
    _check_cuda_layout(q, k_cache, v_cache, lengths)
    B, KV, G, D = q.shape
    T = k_cache.shape[1]
    n_split = num_splits(B, KV, G, D, T, q.dtype)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    part = torch.empty(B * KV * n_split * G * (D + 2), dtype=torch.float32,
                       device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(
        _DTYPE_CODE[q.dtype], B, KV, G, D, T, n_split,
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), part.data_ptr(),
        _counters(q.device, stream, B * KV).data_ptr(),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        1.0 / D ** 0.5, stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_decode: kernel launch failed (cudaError {err})")
    LAUNCHES += 1
    return out


def _flash_decode_paged_cuda(q, buf, table, k_offset, v_offset, pos_stride,
                             head_stride, t_len, page_elems, lengths):
    global PAGED_LAUNCHES
    args = (k_offset, v_offset, pos_stride, head_stride, t_len, page_elems)
    check_paged_inputs(q, buf, table, *args, lengths)
    vec = 16 // q.element_size()  # elements per 16-byte load
    if any(n % vec for n in (k_offset, v_offset, pos_stride, head_stride, page_elems)):
        raise ValueError(
            f"flash_decode_paged: offsets ({k_offset}, {v_offset}), strides "
            f"({pos_stride}, {head_stride}) and the page ({page_elems}) must be "
            f"whole multiples of {vec} elements (16 bytes) on the card"
        )
    if not q.is_contiguous() or not table.is_contiguous():
        raise ValueError("flash_decode_paged: q and table must be contiguous")
    if q.data_ptr() % 16 or buf.data_ptr() % 16:
        raise ValueError("flash_decode_paged: q and buf must be 16-byte aligned")
    if any(t.device != q.device for t in (buf, table, lengths)):
        raise ValueError("flash_decode_paged: all inputs must be on one device")
    B, KV, G, D = q.shape
    n_split = num_splits(B, KV, G, D, t_len, q.dtype)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    part = torch.empty(B * KV * n_split * G * (D + 2), dtype=torch.float32,
                       device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _paged_kernel()(
        _DTYPE_CODE[q.dtype], B, KV, G, D, t_len, n_split,
        q.data_ptr(), buf.data_ptr(), table.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), part.data_ptr(),
        _counters(q.device, stream, B * KV).data_ptr(),
        table.shape[1], page_elems, k_offset, v_offset, pos_stride, head_stride,
        1.0 / D ** 0.5, stream,
    )
    if err != 0:
        raise RuntimeError(
            f"flash_decode_paged: kernel launch failed (cudaError {err})")
    PAGED_LAUNCHES += 1
    return out


def _flash_decode_cpu(q, k_cache, v_cache, lengths):
    check_inputs(q, k_cache, v_cache, lengths)
    return flash_decode_ref(q, k_cache, v_cache, lengths)


def _flash_decode_fake(q, k_cache, v_cache, lengths):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


def _flash_decode_lse_cpu(q, k_cache, v_cache, lengths):
    check_inputs(q, k_cache, v_cache, lengths)
    return flash_decode_lse_ref(q, k_cache, v_cache, lengths)


def _flash_decode_lse_fake(q, k_cache, v_cache, lengths):
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty(q.shape[:3], dtype=torch.float32))


def _flash_decode_paged_cpu(q, buf, table, *args):
    check_paged_inputs(q, buf, table, *args)
    return flash_decode_paged_ref(q, buf, table, *args)


def _flash_decode_paged_fake(q, buf, table, *args):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define(
    "flash_decode(Tensor q, Tensor k_cache, Tensor v_cache, Tensor lengths)"
    " -> Tensor"
)
_LIB.impl("flash_decode", _flash_decode_cuda, "CUDA")
_LIB.impl("flash_decode", _flash_decode_cpu, "CPU")
torch.library.register_fake("repro_torch::flash_decode")(_flash_decode_fake)
_LIB.define(
    "flash_decode_lse(Tensor q, Tensor k_cache, Tensor v_cache, Tensor lengths)"
    " -> (Tensor, Tensor)"
)
_LIB.impl("flash_decode_lse", _flash_decode_lse_cuda, "CUDA")
_LIB.impl("flash_decode_lse", _flash_decode_lse_cpu, "CPU")
torch.library.register_fake("repro_torch::flash_decode_lse")(_flash_decode_lse_fake)
_LIB.define(
    "flash_decode_paged(Tensor q, Tensor buf, Tensor table, int k_offset, "
    "int v_offset, int pos_stride, int head_stride, int t_len, int page_elems, "
    "Tensor lengths) -> Tensor"
)
_LIB.impl("flash_decode_paged", _flash_decode_paged_cuda, "CUDA")
_LIB.impl("flash_decode_paged", _flash_decode_paged_cpu, "CPU")
torch.library.register_fake("repro_torch::flash_decode_paged")(
    _flash_decode_paged_fake)


def _sharding(q, k_cache, v_cache, lengths):
    """Acceptable placements of one mesh dim, (output, inputs): all
    replicated, the batch split, or the KV heads split (lengths whole)."""
    from torch.distributed.tensor import Replicate, Shard

    R = Replicate()
    return [([R], [R, R, R, R]),
            ([Shard(0)], [Shard(0), Shard(0), Shard(0), Shard(0)]),
            ([Shard(1)], [Shard(1), Shard(2), Shard(2), R])]


if torch.distributed.is_available():
    from torch.distributed.tensor.experimental import register_sharding

    register_sharding(torch.ops.repro_torch.flash_decode.default)(_sharding)


def flash_decode(q, k_cache, v_cache, lengths) -> torch.Tensor:
    """(B, KV, G, D) attention output in q's dtype."""
    return torch.ops.repro_torch.flash_decode(q, k_cache, v_cache, lengths)


def flash_decode_lse(q, k_cache, v_cache, lengths
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``flash_decode``'s output and each query head's log-sum-exp of its
    scores, fp32 ``(B, KV, G)``; ``lengths`` may be 0 (output 0, -1e30)."""
    return torch.ops.repro_torch.flash_decode_lse(q, k_cache, v_cache, lengths)


def flash_decode_paged(q, buf, table, k_offset: int, v_offset: int,
                       pos_stride: int, head_stride: int, t_len: int,
                       page_elems: int, lengths) -> torch.Tensor:
    """(B, KV, G, D) attention output in q's dtype over the K/V cache of
    ``t_len`` positions read out of the page pool ``buf`` through
    ``table`` (offsets, strides and the page size in elements)."""
    return torch.ops.repro_torch.flash_decode_paged(
        q, buf, table, k_offset, v_offset, pos_stride, head_stride, t_len,
        page_elems, lengths)

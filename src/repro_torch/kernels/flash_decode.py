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

On the card the positions of each ``(b, kv_head)`` are split into
``num_splits(B, KV, T)`` spans, one CTA each, and the last CTA of each
``(b, kv_head)`` merges their partial softmax states (flash-decoding).
The split count comes from the shapes only, so the grid never depends on
``lengths``. The wrapper allocates the fp32 partials (``scratch_bytes``)
with ``torch.empty`` on every call, and keeps one int32 count per
``(b, kv_head)`` for each device and stream, which the kernel leaves at
0; the op has no input for either, so a traced plan does not see them.
Calls on two streams use two sets of counts, so they may overlap. Under
CUDA graph capture the scratch comes from the graph's pool, and the
counts must exist before the capture begins (``_counters``): graphs
captured on one stream share that stream's counts, so they are replayed
one at a time.

``LAUNCHES`` counts kernel launches (the CUDA path only), one per call.
A call under CUDA graph capture launches nothing: ``runtime/graphs.py``
takes it off the count and adds the graph's launches at each replay.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_decode_ref

LAUNCHES = 0

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
# keeping every span at least MIN_SPAN positions long
TARGET_CTAS = 264
MIN_SPAN = 128
MAX_SPLITS = 64  # kMaxSplits of csrc/flash_decode.cu

_FN = None
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


def _kernel():
    global _FN
    if _FN is None:
        fn = build.load("flash_decode").flash_decode_launch
        fn.argtypes = (
            [ctypes.c_int] * 7
            + [ctypes.c_void_p] * 7
            + [ctypes.c_int64] * 6
            + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def num_splits(batch: int, n_kv: int, t_len: int) -> int:
    """Spans per ``(b, kv_head)``: the least power of two that gives
    ``TARGET_CTAS`` CTAs, at most ``t_len // MIN_SPAN`` and ``MAX_SPLITS``
    and at least 1. From the shapes only: (8, 8, 2048), the qwen3 serving
    shape, gives 8 spans of 256 positions."""
    want = -(-TARGET_CTAS // max(batch * n_kv, 1))
    n = 1
    while n < want:
        n *= 2
    return max(1, min(n, t_len // MIN_SPAN, MAX_SPLITS))


def scratch_bytes(batch: int, n_kv: int, group: int, head_dim: int,
                  t_len: int) -> int:
    """Bytes of the fp32 partials (m, l, acc) one call allocates."""
    return batch * n_kv * num_splits(batch, n_kv, t_len) * group * (head_dim + 2) * 4


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
    global LAUNCHES
    check_inputs(q, k_cache, v_cache, lengths)
    _check_cuda_layout(q, k_cache, v_cache, lengths)
    B, KV, G, D = q.shape
    T = k_cache.shape[1]
    n_split = num_splits(B, KV, T)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    part = torch.empty(B * KV * n_split * G * (D + 2), dtype=torch.float32,
                       device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(
        _DTYPE_CODE[q.dtype], B, KV, G, D, T, n_split,
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), part.data_ptr(),
        _counters(q.device, stream, B * KV).data_ptr(),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        1.0 / D ** 0.5, stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_decode: kernel launch failed (cudaError {err})")
    LAUNCHES += 1
    return out


def _flash_decode_cpu(q, k_cache, v_cache, lengths):
    check_inputs(q, k_cache, v_cache, lengths)
    return flash_decode_ref(q, k_cache, v_cache, lengths)


def _flash_decode_fake(q, k_cache, v_cache, lengths):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define(
    "flash_decode(Tensor q, Tensor k_cache, Tensor v_cache, Tensor lengths)"
    " -> Tensor"
)
_LIB.impl("flash_decode", _flash_decode_cuda, "CUDA")
_LIB.impl("flash_decode", _flash_decode_cpu, "CPU")
torch.library.register_fake("repro_torch::flash_decode")(_flash_decode_fake)


def flash_decode(q, k_cache, v_cache, lengths) -> torch.Tensor:
    """(B, KV, G, D) attention output in q's dtype."""
    return torch.ops.repro_torch.flash_decode(q, k_cache, v_cache, lengths)

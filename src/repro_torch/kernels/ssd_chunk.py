"""``repro_torch::ssd_chunk``: one Mamba2 SSD chunk (within-chunk + state update).

Replaces the Pallas TPU kernel ``ssd_chunk`` of
``src/repro/kernels/ssd_chunk.py`` (body ``_kernel``). The op is a
``torch.library`` custom op with two outputs:

* CUDA: the hand-written Hopper kernel ``csrc/ssd_chunk.cu`` (built for
  ``sm_90a`` at first use, see ``kernels/build.py``). A tensor on the
  card never reaches the plain version: a build or launch failure raises;
* CPU: the plain ``kernels/ref.ssd_chunk_ref``;
* fake: shapes and dtypes only, so ``make_fx`` traces the op as ONE node
  with two tensors, as a ``pallas_call`` is one jaxpr equation.

Layout (the TPU kernel's): x ``(B, L, H, P)``, dt and dA ``(B, L, H)``
float32, B and C ``(B, L, H, N)``, state ``(B, H, P, N)``; 1 <= L <= 256.
Every input is read through its element strides and never copied: the
model hands B and C over as the one group ``expand``-ed to all heads
(head stride 0), and x as a slice of the conv output. x, B and C share
one dtype (float32 or bfloat16); the state has its own (float32 or
bfloat16). Returns y ``(B, L, H, P)`` in x's dtype and the new state
``(B, H, P, N)`` in the state's dtype, both contiguous.

``LAUNCHES`` counts kernel launches (the CUDA path only). A call under
CUDA graph capture launches nothing: ``runtime/graphs.py`` takes it off
the count and adds the graph's launches at each replay.

The gradient: ``repro_torch::ssd_chunk_bwd`` takes the six inputs and the
upstream gradients of y and the new state and returns (dx, ddt, ddA, dBm,
dCm, dstate) in the inputs' dtypes. CUDA: the hand-written kernels of
``csrc/ssd_chunk_bwd.cu``, by the dtype of x/B/C as the forward: bf16 on
the tensor cores, a (b, h) split over several CTAs; fp32 on the CUDA
cores, one CTA per (b, h). ``BWD_LAUNCHES`` counts the calls that launch
either. CPU: the plain ``kernels/ref.ssd_chunk_bwd_ref``.
``torch.library.register_autograd`` makes it the backward of
``repro_torch::ssd_chunk``, so a model trains through two hand-written
kernels on the card. The backward kernels read every input through its
strides as the forward does; their outputs are contiguous, and autograd
sums dBm and dCm back over the heads a group's ``expand`` or
``repeat_interleave`` reached.

Under sharding (a step on DTensors, ``launch/mesh.py``) both ops have
sharding rules of their own (``_sharding``, ``_bwd_sharding``): batch on
the batch axes, heads on ``model``, or every input replicated; each rank
launches the kernel on its shard.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ssd_chunk_bwd_ref, ssd_chunk_ref

LAUNCHES = 0
# Calls that launched a backward kernel. A bf16 call also takes a workspace
# from the caching allocator (``bwd_workspace_bytes``: one int32 count and
# 770 float64 partial sums per (b, h), 986,240 B at train_mamba2's
# (2, 256, 80, 64, 128)), freed when the call returns.
BWD_LAUNCHES = 0

HEAD_DIMS = (8, 32, 64)
MAX_STATE = 128
MAX_CHUNK = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_FN = None
_BWD_FN = None


def smem_request_bytes(P: int, N: int, dtype: torch.dtype,
                       state_dtype: torch.dtype) -> int:
    """Bytes of dynamic shared memory one CTA of the instantiation
    ``(dtype, state_dtype, P)`` requests at launch for ``N`` state
    columns, as ``csrc/ssd_chunk.cu`` reports them
    (``ssd_chunk_smem_bytes``); builds the library."""
    fn = build.load("ssd_chunk").ssd_chunk_smem_bytes
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int64
    n = fn(_DTYPE_CODE[dtype], _DTYPE_CODE[state_dtype], P, N)
    if n <= 0:
        raise ValueError(f"ssd_chunk has no instantiation for {dtype}/"
                         f"{state_dtype}, P={P}, N={N}")
    return n


def bwd_smem_request_bytes(P: int, N: int, dtype: torch.dtype,
                           state_dtype: torch.dtype) -> int:
    """``smem_request_bytes`` of the backward kernel
    (``ssd_chunk_bwd_smem_bytes``); builds its library."""
    fn = build.load("ssd_chunk_bwd").ssd_chunk_bwd_smem_bytes
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int64
    n = fn(_DTYPE_CODE[dtype], _DTYPE_CODE[state_dtype], P, N)
    if n <= 0:
        raise ValueError(f"ssd_chunk_bwd has no instantiation for {dtype}/"
                         f"{state_dtype}, P={P}, N={N}")
    return n


def bwd_workspace_bytes(B: int, H: int, dtype: torch.dtype) -> int:
    """Bytes of the workspace one backward call of ``B`` x ``H`` (b, h)
    pairs with x/B/C in ``dtype`` takes (0 for float32), as
    ``ssd_chunk_bwd_workspace_bytes`` of the source gives them; builds
    the library."""
    return _bwd_workspace_fn()(_DTYPE_CODE[dtype], B, H)


@functools.cache
def _bwd_workspace_fn():
    fn = build.load("ssd_chunk_bwd").ssd_chunk_bwd_workspace_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int64
    return fn


def bwd_ctas_per_sm(P: int, N: int, dtype: torch.dtype,
                    state_dtype: torch.dtype) -> int:
    """CTAs of the backward instantiation ``(dtype, state_dtype, P)`` that
    one SM holds at once for ``N`` state columns (the occupancy API on its
    registers, shared memory and threads); needs the card."""
    fn = build.load("ssd_chunk_bwd").ssd_chunk_bwd_ctas_per_sm
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    n = fn(_DTYPE_CODE[dtype], _DTYPE_CODE[state_dtype], P, N)
    if n <= 0:
        raise RuntimeError(f"ssd_chunk_bwd: no occupancy for {dtype}/{state_dtype}, "
                           f"P={P}, N={N} ({n})")
    return n


def _kernel():
    global _FN
    if _FN is None:
        fn = build.load("ssd_chunk").ssd_chunk_launch
        fn.argtypes = (
            [ctypes.c_int] * 7
            + [ctypes.c_void_p] * 8
            + [ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _bwd_kernel():
    global _BWD_FN
    if _BWD_FN is None:
        fn = build.load("ssd_chunk_bwd").ssd_chunk_bwd_launch
        fn.argtypes = (
            [ctypes.c_int] * 7
            + [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
               ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _BWD_FN = fn
    return _BWD_FN


def check_inputs(x, dt, dA, Bm, Cm, state, *, plain: bool = False) -> None:
    """What the kernel takes; raises ``ValueError`` on anything else. The
    plain version (``plain=True``) also takes all six in float64, which
    the CPU's gradient checks need."""
    if x.dim() != 4 or Bm.dim() != 4 or Cm.dim() != 4 or state.dim() != 4:
        raise ValueError(
            f"ssd_chunk: x {tuple(x.shape)} must be (B,L,H,P), B/C "
            f"{tuple(Bm.shape)}/{tuple(Cm.shape)} (B,L,H,N), state "
            f"{tuple(state.shape)} (B,H,P,N)"
        )
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    if (
        Bm.shape != (B, L, H, N) or Cm.shape != (B, L, H, N)
        or dt.shape != (B, L, H) or dA.shape != (B, L, H)
        or state.shape != (B, H, P, N)
    ):
        raise ValueError(
            f"ssd_chunk: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, dA "
            f"{tuple(dA.shape)}, B {tuple(Bm.shape)}, C {tuple(Cm.shape)}, "
            f"state {tuple(state.shape)} do not agree"
        )
    if not (plain and all(t.dtype == torch.float64 for t in (x, dt, dA, Bm, Cm, state))):
        if not (x.dtype == Bm.dtype == Cm.dtype) or x.dtype not in _DTYPE_CODE:
            raise ValueError(
                f"ssd_chunk: x/B/C dtypes {x.dtype}/{Bm.dtype}/{Cm.dtype}; one of "
                f"float32, bfloat16 expected"
            )
        if state.dtype not in _DTYPE_CODE:
            raise ValueError(f"ssd_chunk: state dtype {state.dtype}; float32 or bfloat16")
        if dt.dtype != torch.float32 or dA.dtype != torch.float32:
            raise ValueError("ssd_chunk: dt and dA must be float32")
    if not 1 <= L <= MAX_CHUNK or P not in HEAD_DIMS or not 1 <= N <= MAX_STATE:
        raise ValueError(
            f"ssd_chunk: chunk length {L} (1..{MAX_CHUNK}), head dim {P} (of "
            f"{HEAD_DIMS}) and state dim {N} (1..{MAX_STATE}) are what the "
            f"kernel is built for"
        )


def check_grads(x, state, dy, dnew_state) -> None:
    """The upstream gradients the backward takes: dy like y (x's shape and
    dtype), dnew_state like the new state."""
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"ssd_chunk_bwd: dy {tuple(dy.shape)} {dy.dtype}; "
                         f"{tuple(x.shape)} {x.dtype} expected")
    if dnew_state.shape != state.shape or dnew_state.dtype != state.dtype:
        raise ValueError(f"ssd_chunk_bwd: dnew_state {tuple(dnew_state.shape)} "
                         f"{dnew_state.dtype}; {tuple(state.shape)} {state.dtype} "
                         f"expected")


def _ssd_chunk_cuda(x, dt, dA, Bm, Cm, state):
    global LAUNCHES
    check_inputs(x, dt, dA, Bm, Cm, state)
    dev = x.device
    if any(t.device != dev for t in (dt, dA, Bm, Cm, state)):
        raise ValueError("ssd_chunk: all inputs must be on one device")
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    y = torch.empty((B, L, H, P), dtype=x.dtype, device=dev)
    new_state = torch.empty((B, H, P, N), dtype=state.dtype, device=dev)
    strides = (ctypes.c_int64 * 22)(
        *x.stride(), *dt.stride(), *dA.stride(), *Bm.stride(), *Cm.stride(),
        *state.stride(),
    )
    err = _kernel()(
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[state.dtype], B, L, H, P, N,
        x.data_ptr(), dt.data_ptr(), dA.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), state.data_ptr(), y.data_ptr(), new_state.data_ptr(),
        strides, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ssd_chunk: kernel launch failed (cudaError {err})")
    LAUNCHES += 1
    return y, new_state


def _ssd_chunk_cpu(x, dt, dA, Bm, Cm, state):
    check_inputs(x, dt, dA, Bm, Cm, state, plain=True)
    return ssd_chunk_ref(x, dt, dA, Bm, Cm, state)


def _ssd_chunk_fake(x, dt, dA, Bm, Cm, state):
    check_inputs(x, dt, dA, Bm, Cm, state, plain=True)
    return (
        torch.empty(x.shape, dtype=x.dtype, device=x.device),
        torch.empty(state.shape, dtype=state.dtype, device=state.device),
    )


def _ssd_chunk_bwd_cuda(x, dt, dA, Bm, Cm, state, dy, dnew_state):
    global BWD_LAUNCHES
    check_inputs(x, dt, dA, Bm, Cm, state)
    check_grads(x, state, dy, dnew_state)
    dev = x.device
    if any(t.device != dev for t in (dt, dA, Bm, Cm, state, dy, dnew_state)):
        raise ValueError("ssd_chunk_bwd: all inputs must be on one device")
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    outs = _bwd_empty(x, dt, dA, Bm, Cm, state)
    ins = (x, dt, dA, Bm, Cm, state, dy, dnew_state)
    ws_bytes = bwd_workspace_bytes(B, H, x.dtype)
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=dev) if ws_bytes else None
    ptrs = (ctypes.c_void_p * 15)(*(t.data_ptr() for t in (*ins, *outs)),
                                  None if ws is None else ws.data_ptr())
    strides = (ctypes.c_int64 * 30)(*(s for t in ins for s in t.stride()))
    err = _bwd_kernel()(
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[state.dtype], B, L, H, P, N, ptrs,
        strides, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ssd_chunk_bwd: kernel launch failed (cudaError {err})")
    BWD_LAUNCHES += 1
    return outs


def _bwd_empty(x, dt, dA, Bm, Cm, state):
    """(dx, ddt, ddA, dBm, dCm, dstate), contiguous, in the inputs' dtypes."""
    return tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device)
                 for t in (x, dt, dA, Bm, Cm, state))


def _ssd_chunk_bwd_cpu(x, dt, dA, Bm, Cm, state, dy, dnew_state):
    check_inputs(x, dt, dA, Bm, Cm, state, plain=True)
    check_grads(x, state, dy, dnew_state)
    return ssd_chunk_bwd_ref(x, dt, dA, Bm, Cm, state, dy, dnew_state)


def _ssd_chunk_bwd_fake(x, dt, dA, Bm, Cm, state, dy, dnew_state):
    check_inputs(x, dt, dA, Bm, Cm, state, plain=True)
    check_grads(x, state, dy, dnew_state)
    return _bwd_empty(x, dt, dA, Bm, Cm, state)


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define(
    "ssd_chunk(Tensor x, Tensor dt, Tensor dA, Tensor Bm, Tensor Cm, "
    "Tensor state) -> (Tensor, Tensor)"
)
_LIB.impl("ssd_chunk", _ssd_chunk_cuda, "CUDA")
_LIB.impl("ssd_chunk", _ssd_chunk_cpu, "CPU")
torch.library.register_fake("repro_torch::ssd_chunk")(_ssd_chunk_fake)
_LIB.define(
    "ssd_chunk_bwd(Tensor x, Tensor dt, Tensor dA, Tensor Bm, Tensor Cm, "
    "Tensor state, Tensor dy, Tensor dnew_state) "
    "-> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)"
)
_LIB.impl("ssd_chunk_bwd", _ssd_chunk_bwd_cuda, "CUDA")
_LIB.impl("ssd_chunk_bwd", _ssd_chunk_bwd_cpu, "CPU")
torch.library.register_fake("repro_torch::ssd_chunk_bwd")(_ssd_chunk_bwd_fake)


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, dy, dnew_state):
    x, dt, dA, Bm, Cm, state = ctx.saved_tensors
    if dy is None:  # y unused downstream
        dy = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    if dnew_state is None:  # the last chunk's state, when nothing reads it
        dnew_state = torch.zeros(state.shape, dtype=state.dtype, device=state.device)
    return ssd_chunk_bwd(x, dt, dA, Bm, Cm, state, dy, dnew_state)


torch.library.register_autograd("repro_torch::ssd_chunk", _backward,
                                setup_context=_setup_context)


def _sharding(x, dt, dA, Bm, Cm, state):
    """Acceptable placements of one mesh dim for ``ssd_chunk``, (outputs,
    inputs): all replicated, the batch split, or the heads split (dim 2
    of the per-position inputs, dim 1 of the state)."""
    from torch.distributed.tensor import Replicate, Shard

    R, b, h, hs = Replicate(), Shard(0), Shard(2), Shard(1)
    return [([R, R], [R] * 6), ([b, b], [b] * 6), ([h, hs], [h] * 5 + [hs])]


def _bwd_sharding(x, dt, dA, Bm, Cm, state, dy, dnew_state):
    """``_sharding`` for the backward: dy follows x and dnew_state the
    state; each gradient follows its input."""
    from torch.distributed.tensor import Replicate, Shard

    R, b, h, hs = Replicate(), Shard(0), Shard(2), Shard(1)
    return [([R] * 6, [R] * 8), ([b] * 6, [b] * 8),
            ([h] * 5 + [hs], [h] * 5 + [hs, h, hs])]


if torch.distributed.is_available():
    from torch.distributed.tensor.experimental import register_sharding

    register_sharding(torch.ops.repro_torch.ssd_chunk.default)(_sharding)
    register_sharding(torch.ops.repro_torch.ssd_chunk_bwd.default)(_bwd_sharding)


def ssd_chunk(x, dt, dA, Bm, Cm, state) -> tuple[torch.Tensor, torch.Tensor]:
    """(y (B, L, H, P) in x's dtype, new_state (B, H, P, N) in the state's)."""
    return torch.ops.repro_torch.ssd_chunk(x, dt, dA, Bm, Cm, state)


def ssd_chunk_bwd(x, dt, dA, Bm, Cm, state, dy, dnew_state) -> tuple[torch.Tensor, ...]:
    """(dx, ddt, ddA, dBm, dCm, dstate) of ``ssd_chunk`` for the upstream
    gradients ``dy`` (of y) and ``dnew_state``, in the inputs' dtypes."""
    return torch.ops.repro_torch.ssd_chunk_bwd(x, dt, dA, Bm, Cm, state, dy,
                                               dnew_state)

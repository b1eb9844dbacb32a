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
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ssd_chunk_ref

LAUNCHES = 0

HEAD_DIMS = (8, 32, 64)
MAX_STATE = 128
MAX_CHUNK = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_FN = None


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


def check_inputs(x, dt, dA, Bm, Cm, state) -> None:
    """What the kernel takes; raises ``ValueError`` on anything else."""
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
    check_inputs(x, dt, dA, Bm, Cm, state)
    return ssd_chunk_ref(x, dt, dA, Bm, Cm, state)


def _ssd_chunk_fake(x, dt, dA, Bm, Cm, state):
    check_inputs(x, dt, dA, Bm, Cm, state)
    return (
        torch.empty(x.shape, dtype=x.dtype, device=x.device),
        torch.empty(state.shape, dtype=state.dtype, device=state.device),
    )


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define(
    "ssd_chunk(Tensor x, Tensor dt, Tensor dA, Tensor Bm, Tensor Cm, "
    "Tensor state) -> (Tensor, Tensor)"
)
_LIB.impl("ssd_chunk", _ssd_chunk_cuda, "CUDA")
_LIB.impl("ssd_chunk", _ssd_chunk_cpu, "CPU")
torch.library.register_fake("repro_torch::ssd_chunk")(_ssd_chunk_fake)


def ssd_chunk(x, dt, dA, Bm, Cm, state) -> tuple[torch.Tensor, torch.Tensor]:
    """(y (B, L, H, P) in x's dtype, new_state (B, H, P, N) in the state's)."""
    return torch.ops.repro_torch.ssd_chunk(x, dt, dA, Bm, Cm, state)

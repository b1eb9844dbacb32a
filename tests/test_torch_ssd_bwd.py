"""The backward of the port's ``ssd_chunk`` against the JAX package.

``kernels/ref.ssd_chunk_bwd_ref`` is the analytic VJP of the plain chunk
written out; on the CPU it is the op ``repro_torch::ssd_chunk_bwd`` and,
through ``torch.library.register_autograd``, the backward of
``repro_torch::ssd_chunk``. These tests hold it against ``jax.vjp`` of the
reference's ``kernels/ref.ssd_chunk_ref`` (the oracle in float64, as
``test_torch_ssd.py`` evaluates it), against ``torch.autograd`` of the
port's plain chunk on one chunk and on a chain of 3, at the random
init's fast decay and at a slow one, and run ``gradcheck`` on the op in
float64. The CUDA kernel runs only on the card (``test_torch_cuda.py``,
``chip_smoke.py``'s kernels_ssd_bwd).

Tolerances, as atol + rtol·scale: against the oracle 1e-4 + 1e-4·scale
for the port in fp32 and in float64 alike (the oracle casts x, B, C and
the state to fp32 before its products, even under x64, so its einsums
round as fp32 does; fp32 summation order); the port's backward in
float64 against autograd of its plain chunk in float64 1e-9. The scale is |want|, but for ddA:
ddA_k sums dcum_i over i >= k, and dcum_i is a difference of the decays'
row and column sums, so ddA cancels and its scale is what it sums,
sum_{i>=k} |dcum_i| (``kernels/ref.ssd_chunk_bwd_scale``, through
``ssd_chunk_bwd_tolerance``).

The tensor-core kernel's arithmetic (bf16 x/B/C) is emulated here in
plain PyTorch (``tensor_core_backward``) and held to the same bar: S and
dW from bf16 operands summed in fp32, W, dS, (dy exp(cum))ᵀ and an fp32
state or dns as three bf16 parts, the kernel's decays, the partial sums
of dcum reduced in the kernel's order in float64, each output rounded
once to its dtype.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ref import ssd_chunk_ref as jax_ssd_chunk_ref  # noqa: E402
from repro_torch.bridge import tensor_from_numpy  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import smem_plan as sp  # noqa: E402
from repro_torch.kernels import ssd_chunk as sc  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    ssd_chunk_bwd_ref,
    ssd_chunk_bwd_tolerance,
    ssd_chunk_ref,
)
from repro_torch.launch.roofline import kernel_bound  # noqa: E402
from test_torch_cuda import SSD_CASES, _ssd_inputs  # noqa: E402
from test_torch_ssd import CASES, kernel_decay, make_inputs, split_bf16  # noqa: E402

FP32_TOL = (1e-4, 1e-4)
F64_TOL = (1e-9, 1e-9)
NAMES = ("dx", "ddt", "ddA", "dB", "dC", "dstate")


def upstream(seed, x, state):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(x.shape).astype(np.float32) * 0.5,
            rng.standard_normal(state.shape).astype(np.float32) * 0.5)


def oracle_vjp(arrays, dy, dns):
    """jax.vjp of the reference's chunk in float64."""
    with jax.enable_x64(True):
        primals = [jnp.asarray(np.asarray(a, np.float64)) for a in arrays]
        _, vjp = jax.vjp(jax_ssd_chunk_ref, *primals)
        return [np.asarray(g) for g in vjp((jnp.asarray(dy, jnp.float64),
                                            jnp.asarray(dns, jnp.float64)))]


def _torch(*arrays, dtype=None):
    ts = [tensor_from_numpy(np.ascontiguousarray(a), "cpu") for a in arrays]
    return [t if dtype is None else t.to(dtype) for t in ts]


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_the_jax_oracle_vjp(case):
    """The plain backward in float64 and in fp32 against jax.vjp of the
    reference's oracle in float64."""
    shape, decay = CASES[case]
    arrays = make_inputs(10, *shape, decay=decay)
    dy, dns = upstream(11, arrays[0], arrays[5])
    want = oracle_vjp(arrays, dy, dns)
    L = shape[1]
    got64 = ssd_chunk_bwd_ref(*_torch(*arrays, dy, dns, dtype=torch.float64))
    got32 = sc.ssd_chunk_bwd(*_torch(*arrays, dy, dns))
    for name, g64, g32, w in zip(NAMES, got64, got32, want):
        w = torch.tensor(w)
        assert ssd_chunk_bwd_tolerance(name, g64, w, L, FP32_TOL) <= 1, name
        assert ssd_chunk_bwd_tolerance(name, g32, w, L, FP32_TOL) <= 1, name
    assert [g.dtype for g in got32] == [torch.float32] * 6


@pytest.mark.parametrize("x_dtype,state_dtype",
                         [("bfloat16", "float32"), ("bfloat16", "bfloat16"),
                          ("float32", "bfloat16")])
def test_plain_backward_dtypes(x_dtype, state_dtype):
    """dx, dB and dC come back in x's dtype, ddt and ddA in fp32, dstate in
    the state's dtype; a bf16 output is one rounding off the fp32 one."""
    x, dt, dA, Bm, Cm, state = _torch(*make_inputs(12, 1, 64, 2, 32, 16, decay="slow"))
    x, Bm, Cm = (t.to(getattr(torch, x_dtype)) for t in (x, Bm, Cm))
    state = state.to(getattr(torch, state_dtype))
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(0)).to(x.dtype)
    dns = torch.randn(state.shape, generator=torch.Generator().manual_seed(1)).to(state.dtype)
    got = sc.ssd_chunk_bwd(x, dt, dA, Bm, Cm, state, dy, dns)
    want = ssd_chunk_bwd_ref(*(t.float() for t in (x, dt, dA, Bm, Cm, state, dy, dns)))
    assert [g.dtype for g in got] == [x.dtype, torch.float32, torch.float32, x.dtype,
                                      x.dtype, state.dtype]
    for g, w in zip(got, want):
        assert torch.equal(g, w.to(g.dtype))


@pytest.mark.parametrize("decay", ["original", "slow"])
@pytest.mark.parametrize("n_chunks", [1, 3])
def test_op_autograd_matches_autograd_of_the_plain_chunk(n_chunks, decay):
    """The op's registered backward over 1 chunk and over a chain of 3 (the
    state gradient carried back through two boundaries), in fp32 and in
    float64, against torch.autograd of the plain chunk in float64, B and
    C one group broadcast to the heads (their gradients summed over the
    heads)."""
    L, H = 32, 3
    x, dt, dA, Bm, Cm, state = _torch(*make_inputs(13, 2, L * n_chunks, H, 8, 4,
                                                   decay=decay, groups=1))
    Bg, Cg = Bm[:, :, :1].contiguous(), Cm[:, :, :1].contiguous()
    rng = np.random.default_rng(14)
    dys = _torch(rng.standard_normal(x.shape).astype(np.float32))[0]
    dns = _torch(rng.standard_normal(state.shape).astype(np.float32))[0]

    def grads(core, dtype):
        leaves = [t.to(dtype).requires_grad_() for t in (x, dt, dA, state, Bg, Cg)]
        xx, tt, aa, ss, bg, cg = leaves
        Bh, Ch = bg.expand(-1, -1, H, -1), cg.expand(-1, -1, H, -1)
        total = 0.0
        for c in range(n_chunks):
            sl = slice(c * L, (c + 1) * L)
            y, ss = core(xx[:, sl], tt[:, sl], aa[:, sl], Bh[:, sl], Ch[:, sl], ss)
            total = total + (y * dys[:, sl].to(dtype)).sum()
        total = total + (ss * dns.to(dtype)).sum()
        return torch.autograd.grad(total, leaves)

    got = grads(sc.ssd_chunk, torch.float32)
    got64 = grads(sc.ssd_chunk, torch.float64)
    want = grads(ssd_chunk_ref, torch.float64)
    for name, g, g64, w in zip(("dx", "ddt", "ddA", "dstate", "dB", "dC"), got, got64,
                               want):
        assert ssd_chunk_bwd_tolerance(name, g, w, L, FP32_TOL) <= 1, name
        assert ssd_chunk_bwd_tolerance(name, g64, w, L, F64_TOL) <= 1, name


def test_gradcheck_on_the_op_in_float64():
    """torch.autograd.gradcheck of repro_torch::ssd_chunk (the plain
    version takes float64 on the CPU), B from one group at head stride 0."""
    x, dt, dA, Bm, Cm, state = _torch(*make_inputs(15, 1, 9, 2, 8, 4), dtype=torch.float64)
    Bg = Bm[:, :, :1].clone().requires_grad_()
    leaves = [t.clone().requires_grad_() for t in (x, dt, dA, Cm, state)]

    def f(x, dt, dA, Cm, state, Bg):
        return sc.ssd_chunk(x, dt, dA, Bg.expand(-1, -1, 2, -1), Cm, state)

    assert torch.autograd.gradcheck(f, (*leaves, Bg))


def test_unused_outputs_get_zero_upstream_gradients():
    """y or the new state unread downstream: autograd passes None, which
    the backward takes as zeros (the last chunk's state)."""
    x, dt, dA, Bm, Cm, state = _torch(*make_inputs(16, 1, 16, 2, 8, 4, decay="slow"))
    leaves = [t.requires_grad_() for t in (x, dt, dA, Bm, Cm, state)]
    y, s = sc.ssd_chunk(*leaves)
    got = torch.autograd.grad(y.sum(), leaves)
    want = ssd_chunk_bwd_ref(x, dt, dA, Bm, Cm, state, torch.ones_like(y),
                             torch.zeros_like(s))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    y, s = sc.ssd_chunk(*leaves)
    got = torch.autograd.grad(s.sum(), leaves)
    want = ssd_chunk_bwd_ref(x, dt, dA, Bm, Cm, state, torch.zeros_like(y),
                             torch.ones_like(s))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_masked_decays_leave_no_nan():
    """exp(-inf) above the diagonal gives exact zeros both ways: a chunk
    with a very fast decay (|cum| in the thousands) has finite gradients."""
    x, dt, dA, Bm, Cm, state = _torch(*make_inputs(17, 1, 64, 2, 8, 4))
    dA = dA * 100.0
    got = sc.ssd_chunk_bwd(x, dt, dA, Bm, Cm, state, torch.ones_like(x),
                           torch.ones_like(state))
    assert all(bool(torch.isfinite(g).all()) for g in got)


@pytest.mark.parametrize("bad", ["dy_shape", "dy_dtype", "dns_shape", "dns_dtype",
                                 "float64_on_one"])
def test_backward_refuses_what_the_kernel_does_not_take(bad):
    x, dt, dA, Bm, Cm, state = _torch(*make_inputs(18, 1, 16, 2, 8, 4))
    dy, dns = torch.zeros_like(x), torch.zeros_like(state)
    if bad == "dy_shape":
        dy = dy[:, :8]
    elif bad == "dy_dtype":
        dy = dy.to(torch.bfloat16)
    elif bad == "dns_shape":
        dns = dns[:, :1]
    elif bad == "dns_dtype":
        dns = dns.double()
    else:
        x = x.double()
    with pytest.raises(ValueError):
        sc.ssd_chunk_bwd(x, dt, dA, Bm, Cm, state, dy, dns)


# the planned bytes of one CTA at mamba2-2.7b's (P, N) = (64, 128): the
# CUDA-core kernel's fp32 tiles, and the tensor-core kernel's bf16 ones:
# cum 2048 + the warps' totals 32 + dt, colf and cdt 3 x 1024 + three tile
# pairs of 64 x 136 and 64 x 72 bf16 (3 x 26,624) + the state or dns tile
# (bf16 64 x 136: 17,408; fp32 64 x 132: 33,792); the arrival flag (16)
# reuses the ring
BWD_SMEM_PINS = {("float32", "float32"): 159_808, ("bfloat16", "bfloat16"): 102_432,
                 ("bfloat16", "float32"): 118_816}


@pytest.mark.parametrize("dtype,state_dtype", sorted(BWD_SMEM_PINS))
@pytest.mark.parametrize("P", sp.SSD_HEAD_DIMS)
def test_backward_smem_plan_fits_under_the_request(P, dtype, state_dtype):
    """One CTA's planned shared memory fits the H100's opt-in limit for
    every state width, per instantiation; the card's SMEM test holds it
    under what the source's ``ssd_chunk_bwd_smem_bytes`` requests."""
    for N in range(1, sp.SSD_MAX_N + 1):
        kp = sp.plan_ssd_chunk_bwd_smem(P=P, N=N, dtype=dtype, state_dtype=state_dtype)
        assert kp.fits and kp.plan.total_size <= sp.SMEM_BYTES
    if P == 64:
        kp = sp.plan_ssd_chunk_bwd_smem(P=64, N=128, dtype=dtype, state_dtype=state_dtype)
        assert kp.plan.total_size == BWD_SMEM_PINS[dtype, state_dtype]
    if dtype == "bfloat16":
        # two CTAs share an SM (228 KiB, 1 KiB of it per resident block)
        # wherever the state is bf16, as at train_mamba2's call
        kp = sp.plan_ssd_chunk_bwd_smem(P=P, N=128, dtype=dtype, state_dtype=state_dtype)
        fits_two = 2 * (kp.plan.naive_size + 1024) <= 228 * 1024
        assert fits_two or state_dtype == "float32"


def test_backward_bound_at_mamba2s_chunk():
    """The bytes the function moves at mamba2-2.7b's chunk (bf16, B and C
    one group read once, dB and dC written per head) and its FLOPs (the
    causal half of five L x L products and four L x P x N ones)."""
    shape = {"B": 1, "L": 256, "H": 80, "P": 64, "N": 128, "dtype": "bfloat16",
             "state_dtype": "bfloat16", "groups": 1}
    b = kernel_bound("ssd_chunk_bwd", shape, card_name="NVIDIA H100 80GB HBM3")
    assert b.min_bytes == (3 * 256 * 80 * 64 * 2 + 4 * 256 * 80 * 4 + 2 * 256 * 128 * 2
                           + 2 * 256 * 80 * 128 * 2 + 3 * 80 * 64 * 128 * 2)
    assert b.min_bytes == 22_740_992  # the state and dns read, dstate written, once
    pairs = 256 * 257 // 2
    assert b.flops == 80 * 2 * ((3 * 128 + 2 * 64) * pairs + 4 * 256 * 64 * 128)
    assert b.bound_by == "bytes"


def test_an_edited_header_moves_every_library_digest(tmp_path, monkeypatch):
    """``build.library_path`` hashes the headers beside the sources (the
    SSD kernels' ``ssd_tc.cuh``), so an edited header never loads a stale
    library."""
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "b.cu").write_text("int b;\n")
    (tmp_path / "h.cuh").write_text("int h;\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    before = {n: build.library_path(n) for n in ("a", "b")}
    (tmp_path / "h.cuh").write_text("int h2;\n")
    after = {n: build.library_path(n) for n in ("a", "b")}
    assert all(before[n] != after[n] for n in before)
    assert build.library_path("a") == after["a"]  # the digest is stable


# ------------------------------------------------ the tensor-core arithmetic


def _parts(t: torch.Tensor, parts: int) -> list[torch.Tensor]:
    """A bf16 operand whole; an fp32 one as ``parts`` bf16 terms."""
    return [t.float()] if t.dtype == torch.bfloat16 else split_bf16(t.float(), parts)


def tensor_core_backward(x, dt, dA, Bm, Cm, state, dy, dns, parts=3, rounded=True):
    """The arithmetic of ``ssd_chunk_bwd_tc_kernel`` in plain PyTorch, for
    bf16 x/B/C/dy: S = C·Bᵀ and dW = dy·xᵀ from whole bf16 operands summed
    in fp32; the decay as the kernel takes it (``kernel_decay``); W, dS and
    (dy·exp(cum))ᵀ fed to their products as ``parts`` bf16 terms, and an
    fp32 state or dns too (bf16 ones whole); exp(cum), rem and exp(total)
    applied to fp32 results; dcum from the key CTAs' part
    (-dt_j·colsum_j(H) - drem_j·rem_j), the row CTAs' (rowsum_i(H·dt) +
    inter_i) and dtotal, each a float64 of an fp32 sum, then the reverse
    sum in float64. Each output is rounded once to its dtype
    (``rounded``) or left in fp32."""
    X, Bf, Cf, Y = (t.float() for t in (x, Bm, Cm, dy))
    cum = torch.cumsum(dA.double(), dim=1)
    total = cum[:, -1]
    dec = kernel_decay(cum)  # (B, i, j, H)
    S = torch.einsum("bihn,bjhn->bijh", Cf, Bf)
    dW = torch.einsum("bihp,bjhp->bijh", Y, X)
    decdt = dec * dt[:, None]
    W, dS, Hm = S * decdt, dW * decdt, dW * S * dec
    ecum = torch.exp(cum.float())
    erem = torch.exp((total[:, None] - cum).float())
    rem, etot = erem * dt, torch.exp(total.float())
    Bd = sum(torch.einsum("bjhn,bhpn->bjhp", Bf, d) for d in _parts(dns, parts))
    xd = sum(torch.einsum("bjhp,bhpn->bjhn", X, d) for d in _parts(dns, parts))
    dS_parts = split_bf16(dS, parts)
    dx = (sum(torch.einsum("bijh,bihp->bjhp", w, Y) for w in split_bf16(W, parts))
          + rem[..., None] * Bd)
    dB = sum(torch.einsum("bijh,bihn->bjhn", d, Cf) for d in dS_parts) + rem[..., None] * xd
    ys = ecum[..., None] * sum(torch.einsum("bihp,bhpn->bihn", Y, s)
                               for s in _parts(state, parts))
    dC = ys + sum(torch.einsum("bijh,bjhn->bihn", d, Bf) for d in dS_parts)
    drem = (X * Bd).sum(-1)
    colh = Hm.sum(1)  # over the rows i of each key j
    ddt = colh + drem * erem
    dstate = etot[..., None, None] * dns.float() + sum(
        torch.einsum("bihp,bihn->bhpn", a, Cf)
        for a in split_bf16(Y * ecum[..., None], parts))
    dcum = (-(dt * colh).double() - (drem * rem).double()
            + (Hm * dt[:, None]).sum(2).double() + (Cf * ys).sum(-1).double())
    sdot = (state.float() * dns.float()).sum((-1, -2)).double()
    dcum[:, -1] += etot.double() * sdot + (drem * rem).double().sum(1)
    ddA = torch.flip(torch.cumsum(torch.flip(dcum, [1]), 1), [1]).float()
    outs = (dx, ddt, ddA, dB, dC, dstate)
    if not rounded:
        return outs
    return tuple(o.to(t.dtype) for o, t in zip(outs, (x, dt, dA, Bm, Cm, state)))


def _bf16_case(case, state_dtype, seed=31):
    shape, decay, groups = SSD_CASES[case]
    rng = np.random.default_rng(seed)
    inputs = _ssd_inputs(rng, "cpu", *shape, decay, groups, "bfloat16", state_dtype)
    dy = torch.from_numpy(rng.standard_normal(inputs[0].shape, np.float32) * 0.5)
    dns = torch.from_numpy(rng.standard_normal(inputs[5].shape, np.float32) * 0.5)
    return inputs, dy.to(torch.bfloat16), dns.to(inputs[5].dtype)


def _worst(got, want, L, tol=None, names=NAMES):
    return max(ssd_chunk_bwd_tolerance(n, g, w, L, tol) for n, g, w in zip(names, got, want))


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_tensor_core_arithmetic_keeps_the_backward_within_its_bar(case, state_dtype):
    """bf16 x/B/C at both decays, one and two groups, ragged tiles, N = 13
    and 40: the kernel's arithmetic with three bf16 parts, each output
    rounded once, within ``ssd_chunk_bwd_tolerance`` of the plain backward
    in float64 (a bf16 output's bar, 1e-4 + (1e-4 + 2**-8)·|want|)."""
    inputs, dy, dns = _bf16_case(case, state_dtype)
    want = ssd_chunk_bwd_ref(*(t.double() for t in (*inputs, dy, dns)))
    got = tensor_core_backward(*inputs, dy, dns)
    assert [g.dtype for g in got] == [t.dtype for t in inputs]
    assert _worst(got, want, inputs[0].shape[1]) <= 1


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_tensor_core_arithmetic_over_a_slow_decay_chain(state_dtype):
    """Two chunks of 128 at the slow decay, B and C one group: the second
    chunk's dstate (emulated, in the state's dtype) is the first chunk's
    upstream state gradient, and both chunks' gradients stay within the
    bar of the plain backward in float64 on the same upstream gradients."""
    L, H, P, N = 128, 4, 64, 128
    rng = np.random.default_rng(32)
    x, dt, dA, Bm, Cm, state0 = _ssd_inputs(rng, "cpu", 1, 2 * L, H, P, N, "slow", 1,
                                            "bfloat16", state_dtype)
    c1 = [t[:, :L] for t in (x, dt, dA, Bm, Cm)]
    c2 = [t[:, L:] for t in (x, dt, dA, Bm, Cm)]
    _, state1 = ssd_chunk_ref(*c1, state0)
    dy1, dy2 = (torch.from_numpy(rng.standard_normal(c[0].shape, np.float32) * 0.5)
                .to(torch.bfloat16) for c in (c1, c2))
    dns = torch.from_numpy(rng.standard_normal(state0.shape, np.float32) * 0.5).to(
        state0.dtype)
    got2 = tensor_core_backward(*c2, state1, dy2, dns)
    want2 = ssd_chunk_bwd_ref(*(t.double() for t in (*c2, state1, dy2, dns)))
    assert _worst(got2, want2, L) <= 1
    got1 = tensor_core_backward(*c1, state0, dy1, got2[5])
    want1 = ssd_chunk_bwd_ref(*(t.double() for t in (*c1, state0, dy1, got2[5])))
    assert _worst(got1, want1, L) <= 1
    # the chain carries: the first chunk's dstate moves with the second's
    assert float(got2[5].float().abs().max()) > 0.1


# the outputs before their rounding, against the part of the bar the
# arithmetic has once a bf16 output's rounding is paid: 1e-4 + 1e-4·|want|
ARITH_TOL = (1e-4, 1e-4)
ARITH_NAMES = ("dx", "ddt", "ddA", "dB", "dC")


@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_three_bf16_parts_leave_the_arithmetic_room(case):
    """Three bf16 parts (24 significant bits) spend at most a quarter of
    the arithmetic's room, 1e-4 + 1e-4·|want|, on every case (0.076 at
    slow_L256, the largest, when this was written); dstate is fp32 here."""
    inputs, dy, dns = _bf16_case(case, "float32")
    want = ssd_chunk_bwd_ref(*(t.double() for t in (*inputs, dy, dns)))
    got = tensor_core_backward(*inputs, dy, dns, rounded=False)
    assert _worst(got, want, inputs[0].shape[1], ARITH_TOL, ARITH_NAMES) <= 0.25


@pytest.mark.parametrize("case", ["slow_L256", "N13_L130", "two_groups_L96"])
def test_two_bf16_parts_spend_most_of_the_arithmetic_room(case):
    """hi + mid alone (~2**-17 of each term) spends more than a third of
    the arithmetic's room in these cases (slow_L256: 0.93 when this was
    written, against 0.076 with three parts): a rounding of the output
    near its own worst case then takes the element over its bar. That is
    why the kernel feeds three parts."""
    inputs, dy, dns = _bf16_case(case, "float32")
    want = ssd_chunk_bwd_ref(*(t.double() for t in (*inputs, dy, dns)))
    L = inputs[0].shape[1]
    two = _worst(tensor_core_backward(*inputs, dy, dns, parts=2, rounded=False), want, L,
                 ARITH_TOL, ARITH_NAMES)
    three = _worst(tensor_core_backward(*inputs, dy, dns, rounded=False), want, L,
                   ARITH_TOL, ARITH_NAMES)
    assert two > 1 / 3 and two > 5 * three

"""The port's ``ssd_chunk`` against the JAX package's oracle.

On the CPU the ``repro_torch::ssd_chunk`` op runs its plain version
(``kernels/ref.ssd_chunk_ref``); these tests hold it — directly and
through the op — against ``repro.kernels.ref.ssd_chunk_ref``, on the
shapes of ``tests/test_kernels.py``, a ragged chunk (L = 33), L = 1, B
and C given as one group broadcast to the heads through a head stride of
0, and a slow-decay regime. The CUDA kernel itself runs only on the
card: its cases are in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

The oracle is evaluated in float64 on the same values. In float32 its
prefix sum (an XLA reduce_window that sums every prefix on its own)
carries ~2e-5 of error into the decays of neighbouring positions at
|cum| ~ 180, as much as the whole fp32 tolerance here. The port takes
its prefix sums in float64 (see ``ssd_chunk_ref``).

Tolerances, as atol + rtol·|want|: fp32 1e-5 + 1e-5·|want| (summation
order of the fp32 products); outputs stored in bf16 add one rounding,
at most 2**-8·|want|.

The slow-decay cases (dA in [-0.02, -0.001], so exp(total) is ~0.1 to
1 over L = 256) keep the incoming-state terms large: with the original
decay (dA ~ -0.7 per position) the state's share of the new state is
~e**-45, below fp32 resolution, and a kernel that dropped it would pass.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ref import ssd_chunk_ref as jax_ssd_chunk_ref  # noqa: E402
from repro_torch.bridge import tensor_from_numpy  # noqa: E402
from repro_torch.kernels import ssd_chunk as sc  # noqa: E402
from repro_torch.kernels.ref import ssd_chunk_ref  # noqa: E402
from test_ssd_math import brute_force_ssd  # noqa: E402

# (B, L, H, P, N)
KERNEL_SHAPES = [(2, 64, 2, 32, 16), (1, 128, 4, 64, 128), (2, 256, 1, 64, 64)]
CASES = {
    **{f"kernels_{i}": (shape, "original") for i, shape in enumerate(KERNEL_SHAPES)},
    "ragged_L33": ((2, 33, 3, 64, 128), "original"),
    "L1": ((3, 1, 2, 8, 4), "original"),
    "slow_L256": ((1, 256, 4, 64, 128), "slow"),
    "slow_L200_P8": ((2, 200, 3, 8, 4), "slow"),
}
FP32_TOL = (1e-5, 1e-5)
BF16_TOL = (1e-5, 1e-5 + 2.0**-8)


def make_inputs(seed, B, L, H, P, N, decay="original", groups=None):
    """numpy float32 inputs: the distributions of tests/test_kernels.py
    ("original", dA = -exp(0.3 z) * dt) or dA uniform in [-0.02, -0.001]
    ("slow"). ``groups=1`` draws B and C for one group and broadcasts it
    to the heads (a view, as the model passes them)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P), np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H), np.float32)))
    if decay == "slow":
        dA = -rng.uniform(0.001, 0.02, (B, L, H)).astype(np.float32)
    else:
        dA = -np.exp(rng.standard_normal((B, L, H), np.float32) * 0.3) * dt
    G = groups or H
    Bm = rng.standard_normal((B, L, G, N), np.float32) * 0.5
    Cm = rng.standard_normal((B, L, G, N), np.float32) * 0.5
    if groups:
        Bm = np.broadcast_to(Bm, (B, L, H, N))
        Cm = np.broadcast_to(Cm, (B, L, H, N))
    state = rng.standard_normal((B, H, P, N), np.float32) * 0.5
    return x, dt.astype(np.float32), dA.astype(np.float32), Bm, Cm, state


def _as_dtype(a: np.ndarray, dtype: str) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(dtype))


def oracle(*arrays):
    """The JAX oracle in float64 on the given values."""
    with jax.enable_x64(True):
        y, s = jax_ssd_chunk_ref(*(jnp.asarray(np.asarray(a, np.float64))
                                   for a in arrays))
        return np.asarray(y), np.asarray(s)


def ratio(got: torch.Tensor, want: np.ndarray, tol) -> float:
    """max |got - want| / (atol + rtol·|want|): <= 1 passes."""
    atol, rtol = tol
    err = np.abs(got.double().numpy() - want)
    return float((err / (atol + rtol * np.abs(want))).max())


def _torch(*arrays):
    return [tensor_from_numpy(a, "cpu") for a in arrays]


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_ssd_chunk_matches_the_jax_oracle(case):
    shape, decay = CASES[case]
    arrays = make_inputs(0, *shape, decay=decay)
    want_y, want_s = oracle(*arrays)
    y, s = ssd_chunk_ref(*_torch(*arrays))
    assert y.dtype == s.dtype == torch.float32
    assert ratio(y, want_y, FP32_TOL) <= 1 and ratio(s, want_s, FP32_TOL) <= 1
    # the op on CPU tensors is the plain version
    y_op, s_op = sc.ssd_chunk(*_torch(*arrays))
    assert torch.equal(y_op, y) and torch.equal(s_op, s)


@pytest.mark.parametrize("x_dtype,state_dtype",
                         [("bfloat16", "float32"), ("bfloat16", "bfloat16"),
                          ("float32", "bfloat16")])
@pytest.mark.parametrize("case", ["kernels_1", "ragged_L33", "slow_L256"])
def test_plain_ssd_chunk_dtypes(case, x_dtype, state_dtype):
    """x/B/C in one dtype, the state in its own: y comes back in x's
    dtype and the new state in the state's, each one rounding off."""
    shape, decay = CASES[case]
    x, dt, dA, Bm, Cm, state = make_inputs(1, *shape, decay=decay)
    x, Bm, Cm = (_as_dtype(a, x_dtype) for a in (x, Bm, Cm))
    state = _as_dtype(state, state_dtype)
    want_y, want_s = oracle(x, dt, dA, Bm, Cm, state)
    y, s = sc.ssd_chunk(*_torch(x, dt, dA, Bm, Cm, state))
    assert y.dtype == getattr(torch, x_dtype) and s.dtype == getattr(torch, state_dtype)
    tol = {"float32": FP32_TOL, "bfloat16": BF16_TOL}
    assert ratio(y, want_y, tol[x_dtype]) <= 1
    assert ratio(s, want_s, tol[state_dtype]) <= 1


@pytest.mark.parametrize("decay", ["original", "slow"])
def test_one_group_reaches_the_heads_through_a_zero_stride(decay):
    x, dt, dA, Bm, Cm, state = make_inputs(2, 1, 96, 4, 32, 16, decay=decay, groups=1)
    tx, tdt, tdA, tstate = _torch(x, dt, dA, state)
    # the model's view: one group, expanded over the head axis
    tB = tensor_from_numpy(np.ascontiguousarray(Bm[:, :, :1]), "cpu").expand(1, 96, 4, 16)
    tC = tensor_from_numpy(np.ascontiguousarray(Cm[:, :, :1]), "cpu").expand(1, 96, 4, 16)
    assert tB.stride(2) == 0 and tC.stride(2) == 0
    want_y, want_s = oracle(x, dt, dA, Bm, Cm, state)
    y, s = sc.ssd_chunk(tx, tdt, tdA, tB, tC, tstate)
    assert ratio(y, want_y, FP32_TOL) <= 1 and ratio(s, want_s, FP32_TOL) <= 1


@pytest.mark.parametrize("case", ["slow_L256", "slow_L200_P8"])
def test_slow_decay_makes_the_state_terms_count(case):
    """Zeroing the incoming state removes exactly y_inter from y and
    state·exp(total) from the new state: in the slow-decay cases each
    moves the output by more than 100x the fp32 tolerance, so a kernel
    that dropped either term fails there."""
    shape, decay = CASES[case]
    x, dt, dA, Bm, Cm, state = _torch(*make_inputs(0, *shape, decay=decay))
    y, s = ssd_chunk_ref(x, dt, dA, Bm, Cm, state)
    y0, s0 = ssd_chunk_ref(x, dt, dA, Bm, Cm, torch.zeros_like(state))
    assert ratio(y0, y.double().numpy(), FP32_TOL) > 100  # y_inter
    assert ratio(s0, s.double().numpy(), FP32_TOL) > 100  # state·exp(total)


@pytest.mark.parametrize(
    "bad", ["x_rank", "chunk_len", "head_dim", "state_dim", "dt_dtype",
            "mixed_xbc", "state_int", "shape_mismatch"]
)
def test_ssd_chunk_refuses_what_the_kernel_does_not_take(bad):
    x, dt, dA, Bm, Cm, state = _torch(*make_inputs(3, 1, 16, 2, 8, 4))
    if bad == "x_rank":
        x = x[0]
    elif bad == "chunk_len":
        x, dt, dA, Bm, Cm = (torch.cat([t] * 17, dim=1) for t in (x, dt, dA, Bm, Cm))
    elif bad == "head_dim":
        x, state = x[..., :6], state[:, :, :6]
    elif bad == "state_dim":
        Bm, Cm, state = (torch.cat([t] * 33, dim=-1) for t in (Bm, Cm, state))
    elif bad == "dt_dtype":
        dt = dt.double()
    elif bad == "mixed_xbc":
        Bm = Bm.to(torch.bfloat16)
    elif bad == "state_int":
        state = state.to(torch.int32)
    else:
        state = state[:, :1]
    with pytest.raises(ValueError):
        sc.ssd_chunk(x, dt, dA, Bm, Cm, state)


@pytest.mark.parametrize("decay", ["original", "slow"])
@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_chained_plain_ssd_chunk_matches_brute_force(chunk, decay):
    """Chained over chunks, the state hand-off reproduces the brute-force
    O(S²) recurrence of tests/test_ssd_math.py (float64) at 2e-4."""
    B, S, H, P, N = 1, 64, 2, 8, 4
    arrays = make_inputs(4, B, S, H, P, N, decay=decay)
    with jax.enable_x64(True):
        want_y, want_state = (np.asarray(a) for a in brute_force_ssd(
            *(jnp.asarray(a) for a in arrays)))
    x, dt, dA, Bm, Cm, st = _torch(*arrays)
    ys = []
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        y, st = sc.ssd_chunk(x[:, sl], dt[:, sl], dA[:, sl], Bm[:, sl], Cm[:, sl], st)
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, dim=1).numpy(), want_y, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(st.numpy(), want_state, rtol=2e-4, atol=2e-4)


def split_bf16(a: torch.Tensor, parts: int) -> list[torch.Tensor]:
    """fp32 ``a`` as ``parts`` bf16 terms (as fp32 tensors): each the bf16
    rounding of what the terms before it left, as ``split3`` of the CUDA
    kernel takes hi, mid and lo."""
    out, rest = [], a
    for _ in range(parts):
        term = rest.to(torch.bfloat16).float()
        out.append(term)
        rest = rest - term
    return out


def kernel_decay(cum: torch.Tensor, tile: int = 64) -> torch.Tensor:
    """(B, Lq, Lk, H) fp32 decay as the tensor-core kernel takes it from the
    float64 prefix sum: below the diagonal tile of row i (j < i0, the first
    row of i's tile) the product exp(cum_i - cum_i0)·exp(cum_i0 - cum_j) of
    two decays, each at most 1; on it exp(cum_i - cum_j) directly; 0 above
    the diagonal."""
    L = cum.shape[1]
    i = torch.arange(L)
    i0 = i // tile * tile
    direct = torch.exp((cum[:, :, None, :] - cum[:, None, :, :]).float())
    row = torch.exp((cum - cum[:, i0]).float())  # (B, Lq, H)
    col = torch.exp((cum[:, i0][:, :, None, :] - cum[:, None, :, :]).float())
    below = i[None, :] < i0[:, None]  # (Lq, Lk): j < i0
    causal = i[None, :] <= i[:, None]
    decay = torch.where(below[None, :, :, None], row[:, :, None, :] * col, direct)
    return torch.where(causal[None, :, :, None], decay, torch.zeros(()))


def tensor_core_emulation(x, dt, dA, Bm, Cm, state, parts=3):
    """The tensor-core kernel's arithmetic in plain PyTorch, for bf16 x/B/C:
    products of bf16 operands summed in fp32; W = (C Bᵀ)·decay·dt, with the
    kernel's decay (``kernel_decay``), fed to W·x as ``parts`` bf16 terms;
    y_inter = exp(cum_i)·(C stateᵀ), with an fp32 state in ``parts`` terms
    (a bf16 state is exact); the new state from (x·rem)ᵀ B with x·rem in
    ``parts`` terms."""
    cum = torch.cumsum(dA.double(), dim=1)
    total = cum[:, -1]
    W = (torch.einsum("blhn,bmhn->blmh", Cm.float(), Bm.float())
         * kernel_decay(cum) * dt[:, None])
    y = sum(torch.einsum("blmh,bmhp->blhp", w, x.float()) for w in split_bf16(W, parts))
    st = state.float()
    st_parts = [st] if state.dtype == torch.bfloat16 else split_bf16(st, parts)
    inter = sum(torch.einsum("blhn,bhpn->blhp", Cm.float(), s) for s in st_parts)
    y = torch.exp(cum.float())[..., None] * inter + y
    rem = torch.exp((total[:, None, :] - cum).float()) * dt
    xr = x.float() * rem[..., None]
    dBx = sum(torch.einsum("blhn,blhp->bhpn", Bm.float(), p) for p in split_bf16(xr, parts))
    return y, st * torch.exp(total.float())[..., None, None] + dBx


def _bf16_inputs(case, state_dtype):
    shape, decay = CASES[case]
    x, dt, dA, Bm, Cm, state = _torch(*make_inputs(0, *shape, decay=decay))
    x, Bm, Cm = (t.to(torch.bfloat16) for t in (x, Bm, Cm))
    return x, dt, dA, Bm, Cm, state.to(getattr(torch, state_dtype))


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_three_bf16_parts_keep_the_plain_result_within_the_fp32_bar(case, state_dtype):
    """bf16 x/B/C at both decays: the kernel's decay, and the hi/mid/lo
    split of W, of the decayed x and of an fp32 state, keep y and the new
    state (before any rounding of the output) within the fp32 part of the
    bar, 1e-5 + 1e-5·|want|, of the plain version computed in fp32 on the
    same inputs. A bf16 output adds its one rounding on top, and its bar
    has room for that only."""
    inputs = _bf16_inputs(case, state_dtype)
    x, dt, dA, Bm, Cm, state = inputs
    want_y, want_s = ssd_chunk_ref(x.float(), dt, dA, Bm.float(), Cm.float(),
                                   state.float())
    y, s = tensor_core_emulation(*inputs)
    assert ratio(y, want_y.double().numpy(), FP32_TOL) <= 1
    assert ratio(s, want_s.double().numpy(), FP32_TOL) <= 1


@pytest.mark.parametrize("case", ["kernels_1", "ragged_L33", "slow_L200_P8", "slow_L256"])
def test_two_bf16_parts_are_not_enough(case):
    """hi + mid alone drops up to 2**-16 of each term: y misses the fp32
    part of its bar in these cases (at both decays), and at a slow decay so
    does an fp32 new state. That is why the kernel feeds three parts."""
    inputs = _bf16_inputs(case, "float32")
    x, dt, dA, Bm, Cm, state = inputs
    want_y, want_s = ssd_chunk_ref(x.float(), dt, dA, Bm.float(), Cm.float(), state)
    y, s = tensor_core_emulation(*inputs, parts=2)
    assert ratio(y, want_y.double().numpy(), FP32_TOL) > 1
    if CASES[case][1] == "slow" and case == "slow_L256":
        assert ratio(s, want_s.double().numpy(), FP32_TOL) > 1


def test_float64_scan_equals_the_sequential_prefix_sum():
    """The kernel's float64 scan (per-thread runs of 2, a shuffle scan over
    the threads' totals, then over 4 warps' totals) against a sequential
    float64 sum: equal far below one float32 rounding of cum."""
    dA = -np.random.default_rng(11).uniform(0.3, 1.2, 256)
    per_thread = dA.reshape(128, 2).cumsum(axis=1)
    totals = per_thread[:, -1]
    warps = totals.reshape(4, 32).cumsum(axis=1)
    base = np.concatenate([[0.0], warps[:, -1].cumsum()[:-1]])
    thread_base = (warps + base[:, None]).reshape(128) - totals
    scan = (per_thread + thread_base[:, None]).reshape(256)
    seq = np.cumsum(dA)
    assert np.abs(scan - seq).max() <= 1e-12 * np.abs(seq).max()
    assert np.abs(scan - seq).max() < np.spacing(np.float32(np.abs(seq).max())) / 1e3

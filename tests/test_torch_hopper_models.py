"""The two Hopper models of the port: the shared-memory plan of each
kernel (``kernels/smem_plan.py``, twin of the reference's
``kernels/vmem_plan.py``) and the H100 roofline (``launch/roofline.py``,
twin of the reference's ``launch/roofline.py``).

On the CPU: the SMEM plans of both kernels fit at the serving and prefill
shapes and never exceed naive co-residency, an oversized ring is caught,
the fusion search's default budget is the Hopper model's, the kernel
bounds reproduce PERF.md's bound column, ``count_params`` tracks the
port's ``init_params``, and the step count of reduced qwen3 matches a
hand reckoning. Against what the kernels request at launch and the
device's opt-in limit the plans are held on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``'s smem phase).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.launch import roofline as jax_roofline  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro_torch.configs.base import get_config, get_reduced  # noqa: E402
from repro_torch.core.fusion_search import default_local_budget  # noqa: E402
from repro_torch.core.unified import detect_state_axes  # noqa: E402
from repro_torch.kernels import smem_plan as sp  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.models.api import INPUT_SHAPES, DecoderModel, ShapeSpec  # noqa: E402
from repro_torch.runtime.engine import InferenceEngine  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"  # the name the card reports

# qwen3-0.6b's served heads (G = 16 / 8, D = 64) and mamba2-2.7b's SSD
# chunk (P = 64, N = 128), in the dtypes the paths run
SERVING = [dict(G=2, D=64, dtype="bfloat16"), dict(G=2, D=64, dtype="float32")]
PREFILL = [dict(P=64, N=128, dtype="bfloat16", state_dtype="bfloat16"),
           dict(P=64, N=128, dtype="float32", state_dtype="float32")]


def _every_instantiation():
    for dtype in ("float32", "bfloat16"):
        for D, G in sp.FD_PAIRS:
            yield "flash_decode", dict(G=G, D=D, dtype=dtype)
        for state in ("float32", "bfloat16"):
            for P in sp.SSD_HEAD_DIMS:
                for N in (1, 4, 13, 16, 40, 64, 128):
                    yield "ssd_chunk", dict(P=P, N=N, dtype=dtype, state_dtype=state)


def _plan(kernel, shape):
    fn = sp.plan_flash_decode_smem if kernel == "flash_decode" else sp.plan_ssd_chunk_smem
    return fn(**shape)


# ------------------------------------------------------------- SMEM plans


@pytest.mark.parametrize("shape", SERVING)
def test_flash_decode_plan_fits_at_the_serving_shape(shape):
    kp = sp.plan_flash_decode_smem(**shape)
    assert kp.fits and kp.plan.total_size <= sp.SMEM_BYTES
    assert kp.plan.total_size <= kp.plan.naive_size
    # the merges reuse the ring: the plan is the ring alone, 4 x 8 KiB
    assert kp.plan.total_size == sp.FD_STAGES * 8192 < kp.plan.naive_size
    assert kp.plan.lower_bound == kp.plan.total_size


# gemma3-4b's global heads (G = 8 / 4, D = 320) in the dtypes the paths
# run (bf16 serve and prefill, fp32 nowhere yet but built), and gemma3-27b's
GEMMA3 = [dict(G=2, D=320, dtype="bfloat16"), dict(G=2, D=320, dtype="float32"),
          dict(G=2, D=168, dtype="bfloat16"), dict(G=2, D=168, dtype="float32")]


@pytest.mark.parametrize("shape", GEMMA3)
def test_flash_decode_plan_at_the_gemma3_heads(shape):
    """A warp reads one position: tiles of 8 positions, a ring slot of
    2 x 8 rows of D·itemsize bytes (bf16 D = 320: 10 KiB, the ring 40
    KiB); the merges reuse the ring."""
    kp = sp.plan_flash_decode_smem(**shape)
    item = 2 if shape["dtype"] == "bfloat16" else 4
    assert sp.flash_decode_tile(shape["D"], shape["G"], shape["dtype"]) == (
        8, shape["D"] * item // 16)
    assert kp.fits and kp.plan.total_size == sp.FD_STAGES * 2 * 8 * shape["D"] * item
    assert kp.plan.total_size == kp.plan.lower_bound < kp.plan.naive_size


def test_a_merge_larger_than_the_ring_is_planned():
    """nemotron's (192, 12) in fp32 (the CUDA-core kernel) with a ring of 3
    stages: the warps' accumulators (4 x 12 x 192 fp32, 36 KiB) and their
    m and l outgrow the 36 KiB ring of 3 x 2 x 8 rows of 768 B, and the
    plan is the merge."""
    kp = sp.plan_flash_decode_smem(G=12, D=192, dtype="float32", stages=3)
    assert kp.plan.total_size == 2 * 192 + 4 * 12 * 192 * 4 > 3 * 2 * 8 * 768


def test_the_tensor_core_ring_is_planned_by_hand():
    """nemotron's (192, 12) in bf16 runs on the tensor-core kernel: a ring
    of 2 tiles of 64 positions (16 a warp), each K and V rows of 384 B,
    2 x 2 x 64 x 384 = 98,304 B, which the two merges reuse (the warps'
    37,248 B, the spans' 6,192 B). In fp32 the pair stays on the CUDA-core
    layout: 4 tiles of 8 rows of 768 B for K and V."""
    kp = sp.plan_flash_decode_smem(G=12, D=192, dtype="bfloat16")
    assert sp.flash_decode_path(192, 12, "bfloat16") == "tensor_core"
    assert sp.flash_decode_tile(192, 12, "bfloat16") == (64, 24)
    assert kp.plan.total_size == 2 * 2 * 64 * 384 == 98_304 == kp.plan.lower_bound
    assert kp.plan.naive_size == 98_304 + 2 * 192 + 36_864 + 2 * 3072 + 48
    assert kp.fits and 2 * kp.plan.total_size < sp.SM_SHARED_L1_BYTES  # 2 CTAs an SM
    fp32 = sp.plan_flash_decode_smem(G=12, D=192, dtype="float32")
    assert sp.flash_decode_path(192, 12, "float32") == "cuda_core"
    assert fp32.plan.total_size == sp.FD_STAGES * 2 * 8 * 768 == 49_152


@pytest.mark.parametrize("shape", PREFILL)
def test_ssd_chunk_plan_fits_at_the_prefill_shape(shape):
    kp = sp.plan_ssd_chunk_smem(**shape)
    assert kp.fits and kp.plan.total_size <= kp.plan.naive_size
    assert kp.plan.total_size == kp.plan.lower_bound


def test_ssd_chunk_plan_at_the_prefill_shape_in_bytes():
    """bf16: cum 2048 + dt 1024 + column decays 1024 + C, state and the
    two B tiles of 64 x 136 bf16 (17,408 each) + two x tiles of 64 x 72
    bf16 (9,216 each); the warp totals (32 B) live only during the scan."""
    kp = sp.plan_ssd_chunk_smem(P=64, N=128)
    assert kp.plan.total_size == 2048 + 1024 + 1024 + 4 * 17408 + 2 * 9216 == 92160
    assert kp.plan.naive_size == 92160 + 32


@pytest.mark.parametrize("kernel,shape", list(_every_instantiation()))
def test_every_instantiation_fits_under_the_fusion_reserve(kernel, shape):
    kp = _plan(kernel, shape)
    assert kp.fits
    assert kp.plan.total_size <= sp.SMEM_PIPELINE_RESERVE_BYTES
    assert kp.plan.total_size <= kp.plan.naive_size
    assert all(off % 16 == 0 for off in kp.plan.offsets.values())


@pytest.mark.parametrize("stages", [29, 64])
def test_an_oversized_ring_is_caught(stages):
    kp = sp.plan_flash_decode_smem(G=2, D=64, stages=stages)
    assert not kp.fits
    assert kp.plan.total_size == stages * 8192 > sp.SMEM_BYTES
    assert "OVER BUDGET" in kp.summary()


def test_a_ring_just_under_the_limit_fits():
    kp = sp.plan_flash_decode_smem(G=2, D=64, stages=sp.SMEM_BYTES // 8192)
    assert kp.fits


def test_unbuilt_instantiations_are_refused():
    with pytest.raises(ValueError):
        sp.plan_flash_decode_smem(G=6, D=64)
    with pytest.raises(ValueError):
        sp.plan_ssd_chunk_smem(P=16, N=64)
    with pytest.raises(ValueError):
        sp.plan_ssd_chunk_smem(P=64, N=129)
    with pytest.raises(ValueError):
        sp.plan_ssd_chunk_smem(P=64, N=128, dtype="float16")


def test_fusion_budget_is_the_hopper_model():
    assert default_local_budget() == sp.fusion_scratch_budget()
    assert sp.fusion_scratch_budget() == sp.SMEM_BYTES - sp.SMEM_PIPELINE_RESERVE_BYTES
    assert sp.SMEM_BYTES == 232_448 <= sp.SM_SHARED_L1_BYTES


# --------------------------------------------------------------- roofline


def test_the_cards_peaks():
    h100 = roofline.card(H100)
    assert (h100.hbm_bytes_per_s, h100.bf16_flops, h100.nvlink_bytes_per_s) == (
        3.35e12, 989e12, 450e9)
    assert roofline.peak_bandwidth(H100) == 3.35e12
    assert roofline.peak_flops(H100) == 989e12
    assert roofline.card("NVIDIA H200").hbm_bytes_per_s == 4.8e12
    with pytest.raises(ValueError, match="no published peaks"):
        roofline.card("NVIDIA A100-SXM4-80GB")


def test_flash_decode_bound_is_the_tables():
    """B1 at the serving shape: 33.6 MB read at 3.35 TB/s, 10.03 us."""
    b = roofline.kernel_bound("flash_decode", dict(B=8, KV=8, G=2, D=64, T=2048,
                                                   dtype="bfloat16"), card_name=H100)
    assert b.bound_by == "bytes"
    assert b.min_bytes == 33_587_232
    assert b.bound_s * 1e6 == pytest.approx(10.03, rel=0.01)


def test_flash_decode_bound_at_the_gemma3_serving_shape():
    """gemma3-4b's global layer at 8 slots x 2048 (KV = 4, G = 2, D = 320,
    bf16): 83.9 MB of K and V read at 3.35 TB/s, 25.07 us."""
    b = roofline.kernel_bound("flash_decode", dict(B=8, KV=4, G=2, D=320, T=2048,
                                                   dtype="bfloat16"), card_name=H100)
    assert b.bound_by == "bytes"
    assert b.min_bytes == 83_886_080 + 2 * 8 * 4 * 2 * 320 * 2 + 8 * 4
    assert b.bound_s * 1e6 == pytest.approx(25.07, rel=0.001)


def test_ssd_chunk_bound_is_the_tables():
    """B2 at mamba2-2.7b's chunk: 8.16 MB (2.44 us), 1.68 GFLOP on the
    bf16 tensor cores (1.70 us)."""
    b = roofline.kernel_bound("ssd_chunk", dict(B=1, L=256, H=80, P=64, N=128,
                                                dtype="bfloat16", groups=1),
                              card_name=H100)
    assert b.bound_by == "bytes"
    assert b.bytes_s * 1e6 == pytest.approx(2.44, rel=0.01)
    assert b.ops_s * 1e6 == pytest.approx(1.70, rel=0.01)
    assert b.min_bytes == 8_159_232 and b.flops == 1_681_653_760


def test_the_registered_formulas_count_the_kernel_rows():
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.ssd_chunk import ssd_chunk

    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 2, 2, 64), generator=g)
    k = torch.randn((2, 40, 2, 64), generator=g)
    lengths = torch.tensor([3, 40], dtype=torch.int32)
    with FlopCounterMode(display=False) as fc:
        flash_decode(q, k, k, lengths)
    assert fc.get_total_flops() == roofline.flash_decode_flops(q.shape, k.shape)
    x = torch.randn((1, 33, 3, 8), generator=g)
    dt = torch.rand((1, 33, 3), generator=g)
    bm = torch.randn((1, 33, 3, 4), generator=g)
    state = torch.randn((1, 3, 8, 4), generator=g)
    with FlopCounterMode(display=False) as fc:
        ssd_chunk(x, dt, -dt, bm, bm, state)
    assert fc.get_total_flops() == roofline.ssd_chunk_flops(x.shape, state.shape)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-2.7b"])
@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_count_params_tracks_init_params(arch, full):
    """The analytic count leaves out the per-channel vectors (norm scales,
    conv bias, dt bias, A, D): within the 2% tests/test_roofline_counts.py
    allows on the reduced configs, within 0.1% at full width, where the
    vectors weigh less."""
    cfg = get_config(arch) if full else get_reduced(arch)
    params = DecoderModel(cfg, "meta").init(None)
    real = sum(x.numel() for x in torch.utils._pytree.tree_leaves(params))
    assert roofline.count_params(cfg) == pytest.approx(real, rel=1e-3 if full else 0.02)
    assert roofline.count_params(cfg) <= real
    assert roofline.count_params(cfg) == jax_roofline.count_params(jax_get_config(arch)
                                                                    if full else
                                                                    _jax_reduced(arch))


def _jax_reduced(arch):
    from repro.configs.base import get_reduced as jax_get_reduced

    return jax_get_reduced(arch)


@pytest.mark.parametrize("shape", sorted(INPUT_SHAPES))
def test_model_flops_is_the_references(shape):
    from repro.models.api import INPUT_SHAPES as JAX_SHAPES

    for arch in ("qwen3-0.6b", "mamba2-2.7b"):
        assert roofline.model_flops(get_config(arch), INPUT_SHAPES[shape]) == \
            jax_roofline.model_flops(jax_get_config(arch), JAX_SHAPES[shape])
        assert roofline.active_params(get_config(arch)) == roofline.count_params(
            get_config(arch))


def _reduced_engine():
    cfg = dataclasses.replace(get_reduced("qwen3-0.6b"), n_periods=2)
    model = DecoderModel(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    return cfg, model, params, InferenceEngine(cfg, params, n_slots=2, max_len=32,
                                               device="cpu")


def test_step_count_of_reduced_qwen3_by_hand():
    """One decode step of 2 slots x 32 positions (fp32, tied embedding):
    every weight matrix is read once and multiplied by each slot's token
    (the embedding gathers 2 rows and is the unembedding), attention
    reads every cached position; K and V gain one row per slot."""
    cfg, model, params, eng = _reduced_engine()
    B, T = 2, 32
    L, KV, H, D = cfg.n_layers, cfg.n_kv_heads, cfg.n_heads, cfg.resolved_head_dim
    axes = detect_state_axes(model.init_cache, n_slots=B, max_len=T)
    inputs = (model.rope_freqs, torch.zeros((B, 1), dtype=torch.int32),
              torch.zeros(B, dtype=torch.int32), torch.ones(B, dtype=torch.bool))
    count = roofline.step_count(eng.executor.trace, params, inputs,
                                state=eng.caches, axes=axes)
    assert count.flops_by_op["aten.mm"] == 2 * B * roofline.count_params(cfg)
    assert count.flops_by_op["repro_torch.flash_decode"] == 4 * B * T * H * D * L
    n_params = sum(x.numel() for x in torch.utils._pytree.tree_leaves(params))
    assert count.param_bytes == 4 * n_params
    kv_row = KV * D * 4  # one position of one slot of one layer's K (or V)
    assert count.state_read_bytes == 2 * L * B * T * kv_row
    assert count.state_write_bytes == 2 * L * B * kv_row
    assert count.output_bytes == B * cfg.vocab * 4  # the fp32 logits
    assert count.input_bytes == model.rope_freqs.numel() * 4 + B * 4 + B * 4 + B
    # at lengths 5 and 9 attention reads 14 positions, not 64
    short = roofline.step_count(eng.executor.trace, params, inputs,
                                state=eng.caches, axes=axes, lengths=[5, 9])
    assert short.state_read_bytes == 2 * L * 14 * kv_row
    assert short.flops_by_op["repro_torch.flash_decode"] == 4 * 14 * H * D * L
    bound = short.bound(H100)
    assert bound.bound_by == "bytes"
    assert bound.bound_s == pytest.approx(short.min_bytes / 3.35e12)


def test_step_count_of_a_prefill_counts_its_outputs():
    """A prefill reads no state: it writes its caches, which are outputs."""
    from repro_torch.runtime.executor import ArenaExecutor

    cfg = get_reduced("mamba2-2.7b")
    model = DecoderModel(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    S = 300
    tokens = torch.zeros((1, S), dtype=torch.int64)
    ex = ArenaExecutor(lambda p, t: model.prefill(p, {"tokens": t}), params, tokens)
    count = roofline.step_count(ex.trace, params, (tokens,))
    logits, caches = model.prefill(params, {"tokens": tokens})
    assert count.output_bytes == sum(
        x.numel() * x.element_size() for x in torch.utils._pytree.tree_leaves(
            (logits, caches)))
    assert count.state_read_bytes == count.state_write_bytes == 0
    chunks = -(-S // 256)
    assert count.flops_by_op["repro_torch.ssd_chunk"] > 0
    assert count.flops_by_op["repro_torch.ssd_chunk"] % (chunks * cfg.n_layers) == 0
    mf = roofline.model_flops(cfg, ShapeSpec("p", S, 1, "prefill"))
    assert roofline.mfu(mf, 1.0, H100) == pytest.approx(mf / 989e12)

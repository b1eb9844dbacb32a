"""Plain reference of the served models, in fp32 with TF32 off.

Whole-sequence forward passes in plain PyTorch, written from the layer
equations of the decoder the port serves (``repro_arch`` of a
configuration file): RMSNorm as x·rsqrt(mean(x²) + eps)·(1 + scale);
RoPE on the two halves of each head; causal grouped-query attention;
the MoE's softmax router, its top-k renormalised among the chosen and a
SwiGLU expert each; Mamba2 (in_proj to [z | xBC | dt], a causal
depthwise conv with SiLU, the selective scan in closed form, chunk by
chunk, gated RMSNorm, out_proj); zamba2's shared block over
concat(h, token embedding) at 2·d_model before the layers that insert
it; the output head tied to the embedding. It imports nothing of the
program and reads only the weights the benchmark made.

``logits(weights, arch, sequences, positions, precision)`` gives, for
each sequence, the logits at the asked positions. ``precision`` is
``"fp32"`` (the reference) or ``"fp8"``, the control that has to fail
the comparison: every product with a weight the configuration serves in
bf16 computed on float8 e4m3 operands (W8A8: the weight with one scale
per matrix and expert, the input with one scale per row), the products
accumulated in fp32. Layers run one at a time over all the sequences,
each layer's weights made fp32 once.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # the largest finite float8 e4m3fn


@contextlib.contextmanager
def full_fp32():
    """fp32 products in fp32: TF32 off for matmuls and cuDNN."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
        torch.set_float32_matmul_precision(prec)


def fp8_round(x: torch.Tensor, dims: tuple) -> torch.Tensor:
    """x through float8 e4m3, one scale over ``dims``."""
    scale = FP8_MAX / x.abs().amax(dim=dims, keepdim=True).clamp(min=1e-30)
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class Weights:
    """Turns the served weights into fp32 for the reference, or rounds
    the bf16 ones through float8 e4m3 first (``precision="fp8"``); and
    ``mm(x, w)``, a product with a bf16 weight, its input rounded
    through float8 e4m3 by rows under ``"fp8"``."""

    def __init__(self, precision: str):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.fp8 = precision == "fp8"

    def __call__(self, t: torch.Tensor, per_expert: bool = False) -> torch.Tensor:
        x = t.float()
        if not self.fp8 or t.dtype == torch.float32:
            return x
        # one scale per matrix (per expert for an expert stack)
        dims = tuple(range(1, x.dim())) if per_expert else tuple(range(x.dim()))
        return fp8_round(x, dims)

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return (fp8_round(x, (-1,)) if self.fp8 else x) @ w


def rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + scale.float())


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, D) at positions 0..S-1."""
    S, _, D = x.shape
    half = D // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float64,
                                          device=x.device) / half))
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * freqs
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:2 * half]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, x[..., 2 * half:]], -1)


def attention(mm, x, w, n_heads, n_kv, hd, theta, q_chunk=1024):
    """Causal GQA over x (S, d_in) with weights w (fp32)."""
    S = x.shape[0]
    q = rope(mm(x, w["wq"]).view(S, n_heads, hd), theta)
    k = rope(mm(x, w["wk"]).view(S, n_kv, hd), theta)
    v = mm(x, w["wv"]).view(S, n_kv, hd)
    G = n_heads // n_kv
    qg = q.view(S, n_kv, G, hd).permute(1, 2, 0, 3)  # (KV, G, S, hd)
    kt = k.permute(1, 2, 0)  # (KV, hd, S)
    vv = v.permute(1, 0, 2)  # (KV, S, hd)
    out = torch.empty((n_kv, G, S, hd), dtype=x.dtype, device=x.device)
    pos = torch.arange(S, device=x.device)
    for s0 in range(0, S, q_chunk):
        s1 = min(s0 + q_chunk, S)
        sc = torch.matmul(qg[:, :, s0:s1], kt[:, None, :, :s1]) / math.sqrt(hd)
        mask = pos[None, :s1] <= pos[s0:s1, None]
        sc = sc.masked_fill(~mask, float("-inf"))
        out[:, :, s0:s1] = torch.matmul(torch.softmax(sc, -1), vv[:, None, :s1])
    return mm(out.permute(2, 0, 1, 3).reshape(S, n_heads * hd), w["wo"])


def act(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda t: F.gelu(t, approximate="tanh")
    raise ValueError(f"activation {name!r}")


def mlp(mm, x, w, act_name):
    return mm(act(act_name)(mm(x, w["w_gate"])) * mm(x, w["w_in"]), w["w_out"])


def moe(mm, x, w, n_experts, top_k, act_name):
    """Softmax router, top-k renormalised among the chosen, one MLP an
    expert, computed on the tokens routed to it."""
    probs = torch.softmax(x @ w["router"], -1)
    top_v, top_i = torch.topk(probs, top_k, dim=-1)
    gate = top_v / top_v.sum(-1, keepdim=True).clamp(min=1e-9)
    out = torch.zeros_like(x)
    f = act(act_name)
    for e in range(n_experts):
        hit = top_i == e  # (S, k)
        rows = hit.any(-1).nonzero().flatten()
        if rows.numel() == 0:
            continue
        g = (gate * hit).sum(-1)[rows]
        xe = x[rows]
        y = mm(f(mm(xe, w["w_gate"][e])) * mm(xe, w["w_in"][e]), w["w_out"][e])
        out.index_add_(0, rows, g[:, None] * y)
    return out


def ssd(xs, dt, A, Bh, Ch, chunk=64):
    """y_t = Σ_{s≤t} C_t·B_s · exp(Σ_{s<r≤t} dt_r A) · dt_s x_s, chunk by
    chunk, the state carried between chunks. xs (S,H,P), dt (S,H),
    A (H,), Bh/Ch (S,H,N)."""
    S, H, P = xs.shape
    N = Bh.shape[-1]
    state = xs.new_zeros((H, P, N))
    ys = []
    for s0 in range(0, S, chunk):
        s1 = min(s0 + chunk, S)
        x, d, b, c = xs[s0:s1], dt[s0:s1], Bh[s0:s1], Ch[s0:s1]
        cum = torch.cumsum(d * A, 0)  # (L, H)
        L = s1 - s0
        tri = torch.ones((L, L), dtype=torch.bool, device=xs.device).tril()
        seg = cum[:, None, :] - cum[None, :, :]  # (t, s, H)
        decay = torch.exp(torch.where(tri[:, :, None], seg, float("-inf")))
        cb = torch.einsum("thn,shn->tsh", c, b)
        y = torch.einsum("tsh,sh,shp->thp", cb * decay, d, x)
        y = y + torch.einsum("thn,hpn->thp", c, state) * torch.exp(cum)[:, :, None]
        last = torch.exp(cum[-1][None, :] - cum) * d  # (L, H)
        state = (state * torch.exp(cum[-1])[:, None, None]
                 + torch.einsum("sh,shp,shn->hpn", last, x, b))
        ys.append(y)
    return torch.cat(ys, 0)


def mamba(mm, x, w, a, eps):
    S = x.shape[0]
    d_inner = a["ssm_expand"] * a["d_model"]
    P, G, N, K = a["ssm_head_dim"], a["ssm_groups"], a["ssm_state"], a["ssm_conv"]
    H = d_inner // P
    zxbcdt = mm(x, w["in_proj"])
    z = zxbcdt[:, :d_inner]
    xbc = zxbcdt[:, d_inner:2 * d_inner + 2 * G * N]
    dt_raw = zxbcdt[:, 2 * d_inner + 2 * G * N:]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    conv = sum(pad[i:i + S] * w["conv_w"][i] for i in range(K))
    xbc = F.silu(conv + w["conv_b"])
    xs = xbc[:, :d_inner].view(S, H, P)
    Bh = xbc[:, d_inner:d_inner + G * N].view(S, G, N).repeat_interleave(H // G, 1)
    Ch = xbc[:, d_inner + G * N:].view(S, G, N).repeat_interleave(H // G, 1)
    dt = F.softplus(dt_raw + w["dt_bias"])
    y = ssd(xs, dt, -torch.exp(w["A_log"]), Bh, Ch)
    y = (y + xs * w["D"][None, :, None]).reshape(S, d_inner)
    return mm(rms(y * F.silu(z), w["norm"], eps), w["out_proj"])


def _tree(t, fn):
    if isinstance(t, dict):
        return {k: _tree(v, fn) for k, v in t.items()}
    return fn(t)


def _layer_weights(p, i, cast):
    """Layer i of a stacked layer (``i`` None: not stacked), in fp32."""
    def one(leaf, expert=False):
        return cast(leaf if i is None else leaf[i], per_expert=expert)

    out = {}
    for k, v in p.items():
        if k == "moe":
            out[k] = {kk: one(vv, expert=kk != "router") for kk, vv in v.items()}
        elif isinstance(v, dict):
            out[k] = {kk: one(vv) for kk, vv in v.items()}
        else:
            out[k] = one(v)
    return out


def _block(mm, h, emb, w, spec, a, shared):
    eps = a["rms_eps"]
    if spec.get("shared_attn"):
        x = rms(torch.cat([h, emb], -1), shared["ln"], eps)
        H = a["shared_attn_heads"]
        y = x + attention(mm, x, shared["attn"], H, H, 2 * a["d_model"] // H,
                          a["rope_theta"])
        y = y + mlp(mm, rms(y, shared["ln2"], eps), shared["mlp"], a["act"])
        h = h + mm(y, shared["out"])
    x = rms(h, w["ln1"], eps)
    if spec["mixer"] == "attn":
        hd = a.get("head_dim") or a["d_model"] // a["n_heads"]
        h = h + attention(mm, x, w["attn"], a["n_heads"], a["n_kv_heads"], hd,
                          a["rope_theta"])
    else:
        h = h + mamba(mm, x, w["mamba"], a, eps)
    if spec["ffn"] == "mlp":
        h = h + mlp(mm, rms(h, w["ln2"], eps), w["mlp"], a["act"])
    elif spec["ffn"] == "moe":
        h = h + moe(mm, rms(h, w["ln2"], eps), w["moe"], a["n_experts"], a["top_k"],
                    a["act"])
    return h


@torch.no_grad()
def logits(params: dict, a: dict, sequences: list, positions: list,
           precision: str = "fp32") -> list:
    """For each token sequence (1-D int tensor on the weights' device),
    the fp32 logits (len(pos), vocab) at its positions ``pos``."""
    cast = Weights(precision)
    with full_fp32():
        embed = cast(params["embed"])
        embs = [embed[s.long()] for s in sequences]
        hs = [e.clone() for e in embs]
        shared = None
        if "shared_attn" in params:
            shared = _tree(params["shared_attn"], cast)
        for i in range(a["n_periods"]):
            for j, spec in enumerate(a["period"]):
                w = _layer_weights(params["period"][j], i, cast)
                hs = [_block(cast.mm, h, e, w, spec, a, shared)
                      for h, e in zip(hs, embs)]
        for j, spec in enumerate(a.get("remainder", [])):
            w = _layer_weights(params["remainder"][j], None, cast)
            hs = [_block(cast.mm, h, e, w, spec, a, shared)
                      for h, e in zip(hs, embs)]
        out = []
        for h, pos in zip(hs, positions):
            idx = torch.as_tensor(pos, device=h.device, dtype=torch.long)
            out.append(cast.mm(rms(h[idx], params["ln_f"], a["rms_eps"]), embed.T))
        return out

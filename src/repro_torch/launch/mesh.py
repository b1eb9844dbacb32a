"""Production mesh and sharding rules: tensor parallel on ``model``,
FSDP on ``data`` (counterpart of the reference's ``launch/mesh.py``).

``make_production_mesh`` is a function (importing this module touches no
process group). One production mesh is (data=16, model=16), 256 cards;
``multi_pod`` adds a leading ``pod`` axis, (pod=2, data=16, model=16),
512 cards. These are the reference's shapes, so each rule's decision is
comparable with the reference's, rule for rule.

``init_mesh(shape, axes, device, backend=...)`` makes the process group
and the ``DeviceMesh``: NCCL on the card, gloo on the CPU when asked, and
the fake group (``torch.testing._internal.distributed.fake_pg``: one
process stands for every rank, and a collective returns without moving
data) for the device-free dry run (``launch/dryrun.py``).

``ShardingCtx`` holds the rules. Their logic is the reference's, line for
line: batch on (pod, data) when divisible, the ``model`` axis on feature
dims through the ``constrain(x, tag)`` hooks the models call, params
split by their path and shape (Megatron tensor parallel on ``model``,
FSDP on ``data`` for the other dim; a dim that does not divide stays
replicated). A partition spec here is a plain tuple with one entry per
dim, each None, an axis name or a tuple of axis names, because
``jax.sharding.PartitionSpec`` is not importable in the port (``P``
reads a one-name tuple as the name, as it does), so
``tuple(PartitionSpec(...))`` of the reference's spec equals the port's. ``placements(spec)``
turns one into DTensor placements, and ``constrain`` redistributes a
DTensor to them.

A sharded step (``launch/dryrun.build_step``) runs the models' code as it
is, on DTensors, inside ``sharded_ops()``: the mode ``ShardedOps`` steers
the few places where DTensor on its own would fail or would gather what
the reference's GSPMD keeps split (see its docstring).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.tree_util import tree_map

Spec = tuple  # one entry per dim: None | axis name | tuple of axis names


def P(*entries) -> Spec:
    """A partition spec: one entry per dim, None, an axis name or a tuple
    of names; a one-name tuple is read as the name, as the reference's
    ``PartitionSpec`` reads it."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries)


def production_shape(multi_pod: bool = False) -> tuple[tuple[int, ...], tuple[str, ...]]:
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def init_mesh(shape: tuple[int, ...], axes: tuple[str, ...], device: str = "cuda",
              *, backend: str | None = None, rank: int = 0,
              init_method: str | None = None, store=None):
    """The process group (if none is made yet) and a ``DeviceMesh`` of
    ``shape`` named ``axes``. ``backend`` defaults to NCCL on ``cuda``
    and gloo on ``cpu``; ``"fake"`` makes the fake group of
    ``prod(shape)`` ranks in this one process (``rank`` is the rank it
    stands for; a group of another size made earlier in this process is
    taken down first). ``init_method`` (``tcp://localhost:PORT``) or
    ``store`` says where the real ranks meet."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    world = math.prod(shape)
    if backend == "fake" and dist.is_initialized() and dist.get_world_size() != world:
        # one process has one default group: a fake one of another size goes
        dist.destroy_process_group()
    if not dist.is_initialized():
        if backend is None:
            backend = "nccl" if device == "cuda" else "gloo"
        if backend == "fake":
            from torch.testing._internal.distributed.fake_pg import FakeStore

            dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                    world_size=world)
        else:
            dist.init_process_group(backend, init_method=init_method, store=store,
                                    rank=rank, world_size=world)
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cpu",
                         backend: str = "fake"):
    """(data=16, model=16) over 256 cards, or (pod=2, data=16, model=16)
    over 512; by default on the fake group, for the dry run."""
    shape, axes = production_shape(multi_pod)
    return init_mesh(shape, axes, device, backend=backend)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), device: str = "cpu",
                   *, backend: str | None = None, **kwargs):
    return init_mesh(tuple(shape), tuple(axes), device, backend=backend, **kwargs)


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (or of any object whose
    ``shape`` is already that dict, as the tests' stub meshes)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _axes_of(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class ShardingCtx:
    """Mesh + per-arch resolved activation/parameter rules.

    ``seq_parallel`` (Megatron-LM sequence parallelism): shard the
    residual stream's sequence dim over ``model``, so norms and residual
    adds are 1/TP-degree per device.
    """

    mesh: Any
    cfg: ArchConfig
    seq_parallel: bool = False

    # ---- axis sizes (read once: a trace on fake tensors must not build
    # the mesh's rank tensor)
    @functools.cached_property
    def sizes(self) -> dict[str, int]:
        return axis_sizes(self.mesh)

    @property
    def model_size(self) -> int:
        return self.sizes["model"]

    @property
    def data_size(self) -> int:
        return self.sizes["data"] * self.sizes.get("pod", 1)

    @property
    def batch_axes(self):
        return ("pod", "data") if "pod" in self.sizes else ("data",)

    # ---- helpers
    def _axis_if(self, dim: int, axis, size: int):
        return axis if dim % size == 0 and dim >= size else None

    def batch_axis_for(self, b: int):
        """Shard batch over (pod, data) when divisible, else just data,
        else replicate (long_500k's batch=1)."""
        full = math.prod(self.sizes[a] for a in self.batch_axes)
        if b % full == 0:
            return self.batch_axes
        if b % self.sizes["data"] == 0:
            return ("data",)
        return None

    # ---- activation constraint hook (models call constrain(x, tag))
    def constrain(self, x, tag: str):
        """``x`` redistributed to the placements of its tag's spec when it
        is a DTensor; a plain tensor (or a tag with no rule) is returned
        as it is. A DTensor outside ``sharded_ops`` raises: there DTensor
        gathers what the rules split (a remat recompute that left the
        steering would do so quietly)."""
        from torch.distributed.tensor import DTensor

        if not isinstance(x, DTensor):
            return x
        if not steered():
            raise RuntimeError(f"a sharded step's model code ran outside "
                               f"sharded_ops() (constrain {tag!r})")
        spec = self.activation_spec(x, tag)
        if spec is None:
            return x
        placements = self.placements(spec)
        if tuple(x.placements) == placements:
            return x
        return x.redistribute(x.device_mesh, placements)

    def activation_spec(self, x, tag: str):
        ms = self.model_size
        B = x.shape[0]
        batch = self.batch_axis_for(B)
        if tag == "hidden":  # (B, S, D)
            if (
                self.seq_parallel
                and x.ndim == 3
                and x.shape[1] % ms == 0
                and x.shape[1] >= ms
            ):
                return P(batch, "model", None)
            return P(batch, None, None)
        if tag == "ffn":  # (B, S, F)
            return P(batch, None, self._axis_if(x.shape[-1], "model", ms))
        if tag == "heads":  # (B, S, H, hd)
            # never head_dim: the score product contracts it, which would
            # make every score tensor a partial sum to all-reduce
            h_ax = self._axis_if(x.shape[-2], "model", ms)
            return P(batch, None, h_ax, None)
        if tag == "kv_heads":  # (B, T, KV, hd)
            kv_ax = self._axis_if(x.shape[-2], "model", ms)
            if kv_ax is None:
                # context parallelism: shard the cache/sequence dim
                t_ax = self._axis_if(x.shape[1], "model", ms)
                return P(batch, t_ax, None, None)
            return P(batch, None, kv_ax, None)
        if tag == "ssm_heads":  # (B, S, H, P)
            h_ax = self._axis_if(x.shape[-2], "model", ms)
            return P(batch, None, h_ax, None)
        if tag == "experts":  # (B, G, E, C, D)
            e_ax = self._axis_if(x.shape[2], "model", ms)
            return P(batch, None, e_ax, None, None)
        if tag == "experts_ff":  # (B, G, E, C, F)
            e_ax = self._axis_if(x.shape[2], "model", ms)
            f_ax = self._axis_if(x.shape[-1], "model", ms) if e_ax is None else None
            return P(batch, None, e_ax, None, f_ax)
        if tag == "logits":  # (B, S, V) or (B, V)
            # vocabs rarely divide (seamless 256206): an uneven vocab
            # shard is far cheaper than a replicated (B, S, V) tensor
            v_ax = "model" if x.shape[-1] >= ms else None
            if x.ndim == 3:
                return P(batch, None, v_ax)
            return P(batch, v_ax)
        return None

    # ---- parameter shardings
    def param_spec(self, path: str, x) -> Spec:
        """Rule-based param partitioning from the ``"/"``-joined path and
        the shape."""
        ms = self.model_size
        fsdp = "data"  # FSDP axis for the complementary dim
        shape = x.shape
        nd = len(shape)
        # strip the stacked axis (period params have leading n_periods)
        lead = 1 if "period" in path and nd >= 1 else 0
        dims = shape[lead:]

        def fit(d, axis_size):
            return d % axis_size == 0 and d >= axis_size

        name = path.rsplit("/", 1)[-1] if "/" in path else path
        spec: list = [None] * nd

        def put(rel_idx, axis, size):
            d = dims[rel_idx]
            if fit(d, size) and axis not in spec:
                spec[lead + rel_idx] = axis

        if name == "embed":
            # argument shards divide evenly: a vocab that does not divide
            # stays replicated here (the logits rule shards it unevenly)
            put(0, "model", ms)  # vocab
            put(1, fsdp, self.sizes["data"])
            return P(*spec)
        if len(dims) == 0:
            return P(*spec)
        if name in ("wq", "wk", "wv", "w_in", "w_gate", "in_proj") and len(dims) == 2:
            put(1, "model", ms)  # output features (heads*hd / d_ff / inner)
            put(0, fsdp, self.sizes["data"])
            return P(*spec)
        if name in ("wo", "w_out", "out_proj", "out") and len(dims) == 2:
            put(0, "model", ms)  # input features
            put(1, fsdp, self.sizes["data"])
            return P(*spec)
        if len(dims) == 3:  # MoE expert stacks (E, d_in, d_out)
            if fit(dims[0], ms):
                put(0, "model", ms)
                put(1, fsdp, self.sizes["data"])
            else:
                # experts that do not divide (granite's 40): the ff dim
                ff_rel = 2 if name in ("w_in", "w_gate") else 1
                put(ff_rel, "model", ms)
                put(2 if ff_rel == 1 else 1, fsdp, self.sizes["data"])
            return P(*spec)
        if name == "router" and len(dims) == 2:
            return P(*spec)
        if name == "conv_w" and len(dims) == 2:
            put(1, "model", ms)  # conv channels follow the inner dim
            return P(*spec)
        if len(dims) == 1:
            # biases / norms / per-head scalars: replicate (cheap)
            return P(*spec)
        if len(dims) == 2:
            put(1, "model", ms)
            put(0, fsdp, self.sizes["data"])
            return P(*spec)
        return P(*spec)

    def param_shardings(self, params: Any):
        """The params' tree with each leaf's spec, under the reference's
        ``"/"``-joined paths (dict keys, tuple indices)."""
        return map_with_path(self.param_spec, params)

    def cache_shardings(self, caches: Any):
        """KV/state caches: batch over (pod, data) + a trailing heads or
        feature dim over ``model`` when divisible. Decoder caches are
        ``{"period": (n_periods lead ⇒ batch = axis 1), "remainder":
        (batch = axis 0)}``; enc-dec caches ``{"self"/"cross": (L, B, …)
        ⇒ batch = axis 1}``."""
        ms = self.model_size

        def spec_for(batch_axis):
            def f(x):
                nd = len(x.shape)
                spec: list = [None] * nd
                b_ax = self.batch_axis_for(x.shape[batch_axis])
                spec[batch_axis] = b_ax
                if b_ax is None and nd > batch_axis + 2:
                    # batch=1 (long_500k): shard the cache sequence dim
                    # over the idle data axis
                    t = batch_axis + 1
                    ds = self.sizes["data"]
                    if x.shape[t] % ds == 0 and x.shape[t] >= 16 * ds:
                        spec[t] = "data"
                for i in (nd - 2, nd - 1, nd - 3):
                    if (
                        i > batch_axis
                        and spec[i] is None
                        and x.shape[i] % ms == 0
                        and x.shape[i] >= ms
                    ):
                        spec[i] = "model"
                        break
                return P(*spec)

            return f

        if isinstance(caches, dict) and "period" in caches:
            return {
                "period": tree_map(spec_for(1), caches["period"]),
                "remainder": tree_map(spec_for(0), caches["remainder"]),
            }
        if isinstance(caches, dict) and "self" in caches:
            return tree_map(spec_for(1), caches)
        return tree_map(spec_for(0), caches)

    def batch_shardings(self, batch: Any):
        def spec_for(x):
            b_ax = self.batch_axis_for(x.shape[0])
            return P(b_ax, *([None] * (len(x.shape) - 1)))

        return tree_map(spec_for, batch)

    def replicated(self, tree: Any):
        return tree_map(lambda x: (), tree)

    # ---- DTensor side
    def placements(self, spec: Spec) -> tuple:
        """``spec`` as DTensor placements, one per mesh dim in mesh order:
        ``Shard(d)`` where tensor dim d names that axis (a dim over
        ``("pod", "data")`` is split over both, pod major), else
        ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for axis, size in self.sizes.items():
            dim = next((d for d, e in enumerate(spec) if axis in _axes_of(e)), None)
            # a split over one rank is the whole tensor (and DTensor's views
            # refuse to merge away a size-1 dim held as a split)
            out.append(Replicate() if dim is None or size == 1 else Shard(dim))
        return tuple(out)

    def local_shape(self, shape, spec: Spec) -> tuple[int, ...]:
        """One rank's shard shape of a ``shape`` tensor under ``spec``
        (rank 0's, the largest, where a dim does not divide)."""
        out = list(shape)
        for d, e in enumerate(spec):
            k = math.prod(self.sizes[a] for a in _axes_of(e))
            out[d] = -(-out[d] // k)
        return tuple(out)


def map_with_path(fn, tree: Any, prefix: str = "") -> Any:
    """``fn(path, leaf)`` over a tree of dicts and tuples; ``path`` joins
    dict keys and tuple indices with ``"/"``, as the reference's
    ``param_shardings`` names its leaves."""
    def join(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, join(k)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(map_with_path(fn, v, join(i)) for i, v in enumerate(tree))
    return fn(prefix, tree)


# ------------------------------------------------------------ the sharded step

def _view_groups(src: tuple[int, ...], dst: tuple[int, ...]):
    """Pairs (input dims, output dims) of a view whose products match,
    in order (size-1 dims join the group they stand next to)."""
    groups, i, j = [], 0, 0
    while i < len(src) or j < len(dst):
        gi, gj = [], []
        pi = pj = 1
        while True:
            if i < len(src) and (pi < pj or not gi or (pi == pj and src[i] == 1)):
                pi *= src[i]
                gi.append(i)
                i += 1
            elif j < len(dst) and (pj < pi or not gj or (pi == pj and dst[j] == 1)):
                pj *= dst[j]
                gj.append(j)
                j += 1
            else:
                break
        groups.append((gi, gj))
    return groups


def _keeps_shard(src, dst, dim: int, k: int) -> bool:
    """Whether a view ``src`` -> ``dst`` can keep ``dim`` split ``k`` ways
    without a gather: ``dim`` leads its group, and the group's leading
    output dim divides by ``k``."""
    for gi, gj in _view_groups(tuple(src), tuple(dst)):
        if dim in gi:
            lead = next((d for d in gi if src[d] != 1), gi[0])
            out = next((d for d in gj if dst[d] != 1), gj[0] if gj else None)
            return dim == lead and out is not None and dst[out] % k == 0
    return False


_T = torch.Tensor
# the view functions a sharded step fits (``_fit_view``)
_VIEWS = frozenset({_T.reshape, _T.view, torch.reshape, _T.unflatten, _T.flatten,
                    torch.flatten, torch.unflatten, _T.view_as, _T.reshape_as})
# lookups by index over a dim that may be split: a DTensor result is a
# masked pending sum, reduced at once (later views cannot carry the mask)
_GATHERS = frozenset({torch.take_along_dim, _T.take_along_dim, torch.gather,
                      _T.gather, _T.__getitem__, torch.nn.functional.embedding})
# a softmax over a dim that may be split (attention's scores over a key
# axis split across the ranks: ``_SplitSoftmax``)
_SOFTMAXES = frozenset({torch.softmax, _T.softmax, torch.nn.functional.softmax})
# products whose right operand is a weight (``_fsdp_gather``)
_PRODUCTS = frozenset({_T.__matmul__, torch.matmul, _T.matmul, torch.bmm, _T.bmm,
                       torch.mm, _T.mm})


def _fsdp_gather(a, b):
    """``b`` (the right operand of a product, a weight) with its
    contracting dim gathered over every mesh dim on which ``a`` is split
    along another dim (the batch): the FSDP all-gather of a weight at its
    use. DTensor's own choice there would move the activations and leave
    a pending sum of the whole batch's product on every rank."""
    from torch.distributed.tensor import DTensor, Replicate

    if not (isinstance(a, DTensor) and isinstance(b, DTensor)):
        return b
    placements = list(b.placements)
    for m, (pa, pb) in enumerate(zip(a.placements, placements)):
        if (pb.is_shard(b.ndim - 2) and pa.is_shard()
                and pa.dim not in (a.ndim - 1, -1)):
            placements[m] = Replicate()
    if placements == list(b.placements):
        return b
    return b.redistribute(b.device_mesh, tuple(placements))


def _reduce_partial(x):
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor) or not any(p.is_partial() for p in x.placements):
        return x
    placements = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    return x.redistribute(x.device_mesh, placements)


def _fit_view(x, out_shape):
    """``x`` (a DTensor) with every mesh dim that the view to
    ``out_shape`` cannot keep sharded made replicated first (a Partial
    one stays: a view keeps a pending sum)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    placements = list(x.placements)
    changed = False
    for m, p in enumerate(placements):
        if isinstance(p, Shard):
            k = math.prod(mesh.size(n) for n, q in enumerate(placements)
                          if isinstance(q, Shard) and q.dim == p.dim)
            if not _keeps_shard(x.shape, out_shape, p.dim, k):
                placements[m] = Replicate()
                changed = True
    return x.redistribute(x.device_mesh, tuple(placements)) if changed else x


class ShardedOps(torch.overrides.TorchFunctionMode):
    """The model's code, unchanged, over DTensors. Plain tensors the code
    makes (an ``arange`` of positions, a zero state) count as replicated
    (``implicit_replication``, in ``sharded_ops``). Where DTensor alone
    would fail or gather what GSPMD keeps split, the mode steers it:
    - a view that cannot keep a split dim (K/V heads that do not divide
      ``model`` after a projection whose output does) gathers that mesh
      dim first, both ways (``_FitView``);
    - a product gathers its weight's contracting dim where the batch is
      split (FSDP, ``_fsdp_gather``);
    - an embedding lookup, the loss's gather and its log-sum-exp over a
      split vocab stay split (``_embedding``, ``_SplitGather``,
      ``_split_logsumexp``), and a masked pending sum is reduced at once;
    - a softmax over a split dim (attention's scores where K/V are split
      on T) reduces its max and sum across the ranks (``_SplitSoftmax``);
    - an einsum with one split label a mesh dim runs on the shards, the
      label kept or, contracted, a pending sum (``_local_einsum``); an
      empty ``cat`` part is dropped."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _VIEWS and args:
            from torch.distributed.tensor import DTensor

            x = args[0]
            if isinstance(x, DTensor):
                out_shape = _view_shape(func, tuple(x.shape), args[1:], kwargs)
                if out_shape is not None and out_shape != tuple(x.shape):
                    return _FitView.apply(x, out_shape)
        if func in (torch.take_along_dim, torch.Tensor.take_along_dim):
            x, idx = args[0], args[1]
            dim = kwargs.get("dim", args[2] if len(args) > 2 else None)
            if _split_on(x, dim):
                return _SplitGather.apply(x, idx, dim % x.ndim)
        if func in _SOFTMAXES and len(args) <= 2 and "dtype" not in kwargs:
            x = args[0]
            dim = kwargs.get("dim", args[1] if len(args) > 1 else None)
            if isinstance(dim, int) and _split_on(x, dim):
                return _SplitSoftmax.apply(x, dim % x.ndim)
        if func in (torch.logsumexp, torch.Tensor.logsumexp):
            x = args[0]
            dim = kwargs.get("dim", args[1] if len(args) > 1 else None)
            if isinstance(dim, int) and _split_on(x, dim) and not kwargs.get("keepdim"):
                return _split_logsumexp(x, dim)
        if func is torch.Tensor.__getitem__ and _is_lookup(*args[:2]):
            return _embedding(*args[:2])
        if func is torch.cat and args and isinstance(args[0], (list, tuple)):
            args = (_drop_empty(args[0], kwargs.get("dim", args[1] if len(args) > 1
                                                     else 0)), *args[1:])
        if func is torch.einsum and isinstance(args[0], str):
            out = _local_einsum(args[0], *args[1:])
            if out is not None:
                return out
        if func in _PRODUCTS and len(args) >= 2:
            args = (args[0], _fsdp_gather(args[0], args[1]), *args[2:])
        out = func(*args, **kwargs)
        if func in _GATHERS:
            out = _reduce_partial(out)
        return out


def _infer(shape, numel: int) -> tuple[int, ...]:
    shape = [int(n) for n in shape]
    if -1 in shape:
        known = math.prod(n for n in shape if n != -1)
        shape[shape.index(-1)] = numel // max(known, 1)
    return tuple(shape)


def _view_shape(func, shape, rest, kwargs):
    """The shape a view function gives ``shape`` (None for a view this
    does not read, as ``view(dtype)``), by arithmetic: a probe tensor
    would be a node of a traced program."""
    T = torch.Tensor
    numel = math.prod(shape)
    if func in (T.view_as, T.reshape_as):
        return tuple(rest[0].shape)
    if func in (T.flatten, torch.flatten):
        start = kwargs.get("start_dim", rest[0] if rest else 0)
        end = kwargs.get("end_dim", rest[1] if len(rest) > 1 else -1)
        nd = len(shape)
        start, end = start % max(nd, 1), end % max(nd, 1)
        return (*shape[:start], math.prod(shape[start:end + 1]), *shape[end + 1:])
    if func in (T.unflatten, torch.unflatten):
        dim = kwargs.get("dim", rest[0]) % len(shape)
        sizes = _infer(kwargs.get("sizes", rest[1] if len(rest) > 1 else None),
                       shape[dim])
        return (*shape[:dim], *sizes, *shape[dim + 1:])
    new = kwargs.get("shape", kwargs.get("size"))
    if new is None:
        new = rest[0] if len(rest) == 1 and not isinstance(rest[0], int) else rest
    if isinstance(new, torch.dtype) or any(isinstance(n, torch.dtype) for n in new):
        return None
    return _infer(new, numel)


def _split_on(x, dim) -> bool:
    from torch.distributed.tensor import DTensor

    return (isinstance(x, DTensor) and dim is not None
            and any(p.is_shard(dim % x.ndim) for p in x.placements))


class _SplitGather(torch.autograd.Function):
    """``take_along_dim`` of a DTensor split along ``dim`` (the labels'
    logits over a vocab split on ``model``), Megatron's vocab-parallel
    way: each rank reads the indices that fall in its span and the ranks
    sum the picks; the backward scatters the gradient into the rank's
    own span, so neither direction gathers the split tensor."""

    @staticmethod
    def forward(ctx, x, idx, dim):
        from torch.distributed.tensor import DTensor, Partial, Replicate

        mesh = x.device_mesh
        keep = tuple(Replicate() if p.is_shard(dim) else p for p in x.placements)
        if not isinstance(idx, DTensor):
            idx = DTensor.from_local(idx, mesh, (Replicate(),) * mesh.ndim,
                                     run_check=False)
        il = idx.redistribute(mesh, keep).to_local()
        xl = x.to_local()
        li = il.long() - _span_start(x, dim)
        mine = (li >= 0) & (li < xl.shape[dim])
        li = torch.clamp(li, 0, max(xl.shape[dim] - 1, 0))
        picked = torch.where(mine, torch.take_along_dim(xl, li, dim=dim),
                             torch.zeros((), dtype=xl.dtype, device=xl.device))
        part = tuple(Partial() if p.is_shard(dim) else p for p in x.placements)
        shape = list(x.shape)
        shape[dim] = idx.shape[dim]
        out = DTensor.from_local(picked, mesh, part, run_check=False,
                                 shape=torch.Size(shape),
                                 stride=contiguous_stride(shape)).redistribute(mesh, keep)
        ctx.save_for_backward(li, mine)
        ctx.meta = (mesh, x.placements, x.shape, x.stride(), xl.shape, keep, dim)
        return out

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor

        li, mine = ctx.saved_tensors
        mesh, placements, shape, stride, local_shape, keep, dim = ctx.meta
        gl = grad.redistribute(mesh, keep).to_local()
        gl = torch.where(mine, gl, torch.zeros((), dtype=gl.dtype, device=gl.device))
        gx = torch.zeros(local_shape, dtype=gl.dtype, device=gl.device)
        gx = gx.scatter_add(dim, li, gl)
        return DTensor.from_local(gx, mesh, placements, run_check=False, shape=shape,
                                  stride=stride), None, None


def _is_lookup(w, idx) -> bool:
    """``w[idx]``: rows of a 2-D DTensor (an embedding) at integer DTensor
    indices."""
    from torch.distributed.tensor import DTensor

    return (isinstance(w, DTensor) and isinstance(idx, DTensor) and w.ndim == 2
            and not idx.dtype.is_floating_point and idx.dtype != torch.bool)


def _embedding(w, idx):
    """``w[idx]`` with the rows split over the ranks (Megatron's
    vocab-parallel embedding): ``w``'s feature shards are gathered (FSDP),
    and its vocab shards too on a mesh dim where the indices are split;
    each rank then reads the indices in its vocab span and the ranks sum
    the picks. The indices are never gathered (DTensor's own lookup
    gathers them, and a fake group's gather leaves garbage there)."""
    from torch.distributed.tensor import Replicate

    mesh = w.device_mesh
    wp = list(w.placements)
    for m, (p, ip) in enumerate(zip(wp, idx.placements)):
        if p.is_shard(1) or (p.is_shard(0) and ip.is_shard()):
            wp[m] = Replicate()
    if wp != list(w.placements):
        w = w.redistribute(mesh, tuple(wp))
    return _Lookup.apply(w, idx)


class _Lookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, idx):
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

        mesh = w.device_mesh
        wl, il = w.to_local(), idx.to_local().long()
        li = il - _span_start(w, 0)
        mine = (li >= 0) & (li < wl.shape[0])
        li = torch.clamp(li, 0, max(wl.shape[0] - 1, 0))
        rows = torch.where(mine[..., None], wl[li],
                           torch.zeros((), dtype=wl.dtype, device=wl.device))
        part, whole, grad_pl = [], [], []
        for p, ip in zip(w.placements, idx.placements):
            if ip.is_shard():
                part.append(Shard(ip.dim))
                whole.append(Shard(ip.dim))
                grad_pl.append(Partial())
            elif p.is_shard(0):
                part.append(Partial())
                whole.append(Replicate())
                grad_pl.append(Shard(0))
            else:
                part.append(Replicate())
                whole.append(Replicate())
                grad_pl.append(Replicate())
        shape = (*idx.shape, w.shape[1])
        out = DTensor.from_local(rows, mesh, tuple(part), run_check=False,
                                 shape=torch.Size(shape), stride=contiguous_stride(shape))
        ctx.save_for_backward(li, mine)
        ctx.meta = (mesh, tuple(whole), tuple(grad_pl), w.shape, w.stride(), wl.shape)
        return out.redistribute(mesh, tuple(whole))

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor

        li, mine = ctx.saved_tensors
        mesh, whole, grad_pl, shape, stride, local_shape = ctx.meta
        gl = grad.redistribute(mesh, whole).to_local()
        gl = torch.where(mine[..., None], gl,
                         torch.zeros((), dtype=gl.dtype, device=gl.device))
        gw = torch.zeros(local_shape, dtype=gl.dtype, device=gl.device)
        gw.index_put_((li.reshape(-1),), gl.reshape(-1, local_shape[1]), accumulate=True)
        # a rank's rows from its own slice of the batch: a pending sum over
        # the mesh dims that split the indices
        return DTensor.from_local(gw, mesh, grad_pl, run_check=False, shape=shape,
                                  stride=stride), None


def _drop_empty(parts, dim: int):
    """The parts of a ``cat`` without the DTensors empty along ``dim``
    (RoPE's empty tail past an even head dim): DTensor's cat gathers every
    part it cannot split alike, an empty one included."""
    from torch.distributed.tensor import DTensor

    kept = [t for t in parts if not (isinstance(t, DTensor) and t.shape[dim] == 0)]
    return kept if kept else parts


def _local_einsum(eq: str, *ops):
    """``einsum`` of DTensors on each rank's shards, where the placements
    allow it: on every mesh dim at most one label is split, and every
    operand that has that label is split on it (one whole on that mesh
    dim is split first, a slice of its own whose backward gathers). The
    result keeps the split where the output has the label, and is a
    pending sum where the product contracts it (attention's probabilities
    times V over keys split on T: the reference's one all-reduce of a
    (B, C, H·hd) tile in place of the scores). DTensor's own einsum
    flattens the batch labels into one dim, which with a split label
    behind another turns into a strided split that it resolves index by
    index, and it picks its placements by its own cost, which in the
    backward splits the gradient of split scores on another dim. An
    operand without the split label (a whole q against keys split on T)
    gets a gradient that is a pending sum, which ``_LocalEinsum`` writes
    out. None where the placements do not allow it (the caller runs
    DTensor's einsum)."""
    from torch.distributed.tensor import DTensor, Partial, Shard

    if "..." in eq or "->" not in eq or not ops or not all(
            isinstance(o, DTensor) for o in ops):
        return None
    ins, out = eq.replace(" ", "").split("->")
    ins = ins.split(",")
    mesh = ops[0].device_mesh
    if len(ins) != len(ops) or any(o.device_mesh != mesh for o in ops):
        return None
    size = {}
    for labels, o in zip(ins, ops):
        size.update(zip(labels, o.shape))
    placements = []
    want = [list(o.placements) for o in ops]
    grad_pl = [list(o.placements) for o in ops]
    pending = False  # a pending sum in the result or in a gradient
    for m in range(mesh.ndim):
        split = set()
        for labels, o in zip(ins, ops):
            p = o.placements[m]
            if p.is_partial():
                return None
            if p.is_shard():
                split.add(labels[p.dim])
        if not split:
            placements.append(ops[0].placements[m])
            continue
        if len(split) > 1:
            return None
        (lab,) = split
        if size[lab] % mesh.size(m):
            return None
        for i, labels in enumerate(ins):
            if lab in labels:
                want[i][m] = grad_pl[i][m] = Shard(labels.index(lab))
            else:
                grad_pl[i][m] = Partial()
                pending = True
        if lab in out:
            placements.append(Shard(out.index(lab)))
        else:
            placements.append(Partial())
            pending = True
    if pending and not _differentiable(ins, out):
        return None
    ops = [o if list(o.placements) == w else o.redistribute(mesh, tuple(w))
           for o, w in zip(ops, want)]
    shape = torch.Size(size[c] for c in out)
    if pending:
        return _LocalEinsum.apply(eq, shape, tuple(placements),
                                  tuple(tuple(g) for g in grad_pl), *ops)
    local = torch.einsum(eq, *(o.to_local() for o in ops))
    return DTensor.from_local(local, mesh, tuple(placements), run_check=False,
                              shape=shape, stride=_stride_like(local, shape))


def _differentiable(ins, out) -> bool:
    """Whether each operand's gradient is one einsum of the output's
    gradient and the other operands: no label twice in an operand, and
    each label of an operand in the output or in another operand."""
    for i, labels in enumerate(ins):
        if len(set(labels)) != len(labels):
            return False
        rest = out + "".join(ins[j] for j in range(len(ins)) if j != i)
        if any(c not in rest for c in labels):
            return False
    return True


class _LocalEinsum(torch.autograd.Function):
    """``einsum`` on the local shards with an explicit backward, for the
    products whose result or gradients are pending sums: the output's
    gradient comes whole where the result was a pending sum, and each
    operand's local gradient is the einsum of it with the other local
    operands, a pending sum on the mesh dims where the operand lacks the
    split label."""

    @staticmethod
    def forward(ctx, eq, shape, placements, grad_pl, *ops):
        from torch.distributed.tensor import DTensor

        local_ops = [o.to_local() for o in ops]
        local = torch.einsum(eq, *local_ops)
        ctx.save_for_backward(*local_ops)
        mesh = ops[0].device_mesh
        ctx.meta = (eq, mesh, placements, grad_pl, [tuple(o.shape) for o in ops])
        return DTensor.from_local(local, mesh, placements, run_check=False,
                                  shape=shape, stride=_stride_like(local, shape))

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor, Replicate

        eq, mesh, placements, grad_pl, shapes = ctx.meta
        local_ops = ctx.saved_tensors
        ins, out = eq.replace(" ", "").split("->")
        ins = ins.split(",")
        g = grad.redistribute(mesh, tuple(Replicate() if p.is_partial() else p
                                          for p in placements)).to_local()
        grads = []
        for i, labels in enumerate(ins):
            if not ctx.needs_input_grad[4 + i]:
                grads.append(None)
                continue
            rest = [j for j in range(len(ins)) if j != i]
            gl = torch.einsum(",".join([out, *(ins[j] for j in rest)]) + "->" + labels,
                              g, *(local_ops[j] for j in rest))
            grads.append(DTensor.from_local(gl, mesh, grad_pl[i], run_check=False,
                                            shape=torch.Size(shapes[i]),
                                            stride=_stride_like(gl, shapes[i])))
        return (None, None, None, None, *grads)


def _stride_like(local: torch.Tensor, shape) -> tuple[int, ...]:
    """The dense strides of a ``shape`` tensor whose dims lie in memory in
    the order ``local``'s do (an einsum's result is often a permutation)."""
    order = sorted(range(local.dim()), key=lambda d: -local.stride(d))
    stride, acc = [0] * local.dim(), 1
    for d in reversed(order):
        stride[d] = acc
        acc *= max(int(shape[d]), 1)
    return tuple(stride)


def _split_logsumexp(x, dim: int):
    """``logsumexp`` over a dim the ranks split: each rank's max and sum
    of exponentials, reduced across the ranks (a max, then a sum), so the
    split tensor is never gathered. The max is a constant of the
    gradient, as in any stable log-sum-exp."""
    m = _reduce_partial(torch.amax(x, dim=dim, keepdim=True)).detach()
    s = _reduce_partial(torch.sum(torch.exp(x - m), dim=dim))
    return torch.log(s) + m.squeeze(dim)


class _SplitSoftmax(torch.autograd.Function):
    """``softmax`` over a dim the ranks split (attention's scores where the
    keys are split on T, context parallel), without gathering it: each
    rank's max over its span, all-reduced, then its sum of exponentials,
    all-reduced, as the reference's note on the ``kv_heads`` rule has it.
    The backward is softmax's, ``y · (g - Σ g·y)``, with that sum
    all-reduced the same way; it keeps only ``y``."""

    @staticmethod
    def forward(ctx, x, dim):
        e = torch.exp(x - _reduce_partial(torch.amax(x, dim=dim, keepdim=True)))
        y = e / _reduce_partial(torch.sum(e, dim=dim, keepdim=True))
        ctx.save_for_backward(y)
        ctx.dim = dim
        return y

    @staticmethod
    def backward(ctx, grad):
        (y,) = ctx.saved_tensors
        gy = grad * y
        return gy - y * _reduce_partial(torch.sum(gy, dim=ctx.dim, keepdim=True)), None


def _span_start(x, dim: int) -> int:
    """Where this rank's shard of DTensor ``x`` starts along ``dim``: the
    chunks of ``torch.chunk``, split over the mesh dims in mesh order."""
    coord = x.device_mesh.get_coordinate()
    start, size = 0, x.shape[dim]
    for m, p in enumerate(x.placements):
        if p.is_shard(dim):
            chunk = -(-size // x.device_mesh.size(m))
            lo = min(coord[m] * chunk, size)
            start += lo
            size = min(chunk, size - lo)
    return start


def contiguous_stride(shape) -> tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= max(int(n), 1)
    return tuple(reversed(stride))


class _FitView(torch.autograd.Function):
    """A view of a DTensor fitted both ways: the forward gathers what the
    view cannot keep sharded, and so does the backward for the gradient,
    which may arrive sharded where the forward's input was not (a
    gradient through a row-parallel product is split on its features)."""

    @staticmethod
    def forward(ctx, x, out_shape):
        ctx.in_shape = tuple(x.shape)
        return _fit_view(x, out_shape).reshape(out_shape)

    @staticmethod
    def backward(ctx, grad):
        return _fit_view(grad, ctx.in_shape).reshape(ctx.in_shape), None


def clear_sharding_caches() -> None:
    """Empty DTensor's sharding-propagation caches. A process that runs
    several models' steps calls it before each: on torch 2.13 a cached
    entry of one model's view was replayed for another's view of another
    shape (the local shape it gave did not fit the tensor)."""
    from torch.distributed.tensor import DTensor

    clear = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache", None)
    if clear is not None:
        clear()
    cached = DTensor._op_dispatcher.sharding_propagator.propagate_op_sharding
    if hasattr(cached, "cache_clear"):
        cached.cache_clear()


def steered() -> bool:
    """Whether the code running now is under ``sharded_ops``."""
    return any(isinstance(m, ShardedOps)
               for m in torch.overrides._get_current_function_mode_stack())


def sharded_ops():
    """The context a sharded step runs in: ``ShardedOps`` under
    ``implicit_replication``."""
    import contextlib

    from torch.distributed.tensor.experimental import implicit_replication

    stack = contextlib.ExitStack()
    stack.enter_context(implicit_replication())
    stack.enter_context(ShardedOps())
    return stack

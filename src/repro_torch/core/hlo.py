"""Executed-work accounting of a torch program: the twin of
``src/repro/core/hlo.py``, the framework's "NCU".

The reference parses the HLO text of a lowered program and multiplies each
``while`` body by its trip count. This package has no HLO: ``Counter`` is a
``TorchDispatchMode`` that sees every aten op the program runs (on ``meta``
tensors in the dry run, so nothing is allocated) and fills the same
``ModuleStats`` record, with the same rules:

  * **products** (every op of ``torch.utils.flop_counter``'s registry:
    ``mm``, ``bmm``, ``addmm``, convolutions, ...): their FLOPs, and their
    operands' and result's bytes;
  * **reductions and sorts** (``sum``, ``amax``, ``softmax``, ``sort``,
    ``topk``, ...): operands' and result's bytes, and result elements;
  * **slices and gathers** (``select``, ``slice``, ``index_select``,
    ``gather``, ``embedding``, ...): 2 x the result's bytes;
  * **updates and scatters** (``copy_``, ``index_copy``, ``index_put``,
    ``scatter``, ``slice_scatter``, ...): 2 x the update's bytes;
  * **elementwise chains**: no bytes (the reference assumes they fuse
    away), their result elements (and transcendentals) counted;
  * views, reshapes, casts, concatenations, pads and creations: nothing,
    as the reference's pre-fusion rules skip their opcodes;
  * **collectives** (``c10d`` and ``_c10d_functional`` ops): bytes by
    ``_traffic``.

The reference's dry run reads the pre-fusion module after SPMD
partitioning, so its bytes are those rules, not a fused kernel's; the
counter keeps them. ``hbm_bytes_boundary`` adds the eager model beside
them: every op that moves data reads its operands and writes its result,
as each op is its own kernel when PyTorch runs eagerly.

**One rank's work under a mesh.** The reference's dry run reads the
module after SPMD partitioning: per device shapes, and the collectives the
partitioner inserted. Here the sharded step runs over DTensors on ``meta``
blocks in a one-process ``fake`` world (``launch/mesh.py``). A dispatch
mode sees a DTensor op before DTensor does, at its global shapes, and never
sees the collectives DTensor issues inside the op's dispatch; so for an op
with a DTensor operand the counter returns ``NotImplemented`` (the hook
``CommDebugMode`` uses), DTensor runs, and what it runs on the local
blocks, its redistributions' functional collectives and the local compute,
comes back into the counter with plain tensors at one rank's shapes. The
shape propagation DTensor does on ``FakeTensor``s is not work and is not
counted. A collective's bytes follow ``_traffic`` on its local operand
and result.

**Loops.** A ``while`` body counts trip-count times in the reference. Here
``with counter.loop(trips):`` counts what runs inside it ``trips`` times,
and ``steps(n, device)`` (from the leaf module ``repro_torch._loops``,
which the kernels and models import) is the range of a Python loop that,
under an active counter on ``meta`` tensors, runs two iterations, the
second under a multiplicity of n - 1 (the plain scan's time loop, the
SSD's chunk loop): a 32,768-step loop is counted from two steps, its
backward too.
"""
from __future__ import annotations

import contextlib
import math
import sys
import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch._loops import _ACTIVE, active, steps  # noqa: F401 (re-exported)

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute", "ragged-all-to-all", "collective-broadcast")

# the collectives of torch.distributed (``c10d``) and its functional ones,
# and their HLO opcode
_COLLECTIVE_OPS = {"allreduce_": "all-reduce", "all_reduce": "all-reduce",
                   "allgather_": "all-gather", "_allgather_base_": "all-gather",
                   "all_gather_into_tensor": "all-gather",
                   "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
                   "reduce_scatter_tensor": "reduce-scatter",
                   "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
                   "all_to_all_single": "all-to-all",
                   "send": "collective-permute", "broadcast_": "collective-broadcast",
                   "broadcast": "collective-broadcast",
                   "shard_dim_alltoall": "all-to-all"}

_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin", "prod",
           "var", "var_mean", "std", "std_mean", "logsumexp", "linalg_vector_norm",
           "norm", "any", "all", "_softmax", "_log_softmax", "_softmax_backward_data",
           "_log_softmax_backward_data", "nll_loss_forward", "nll_loss_backward"}
_SORT = {"sort", "topk", "argsort"}
_GATHER = {"select", "slice", "narrow", "index_select", "gather", "index", "embedding",
           "take", "unbind", "split", "split_with_sizes", "chunk", "diagonal"}
_UPDATE = {"copy_", "index_copy", "index_copy_", "index_put", "index_put_", "scatter",
           "scatter_", "scatter_add", "scatter_add_", "scatter_reduce", "index_add",
           "index_add_", "slice_scatter", "select_scatter", "masked_scatter",
           "select_backward", "slice_backward", "embedding_dense_backward",
           "index_select_backward"}
# no traffic and no element work (the reference's _NO_TRAFFIC and the
# opcodes its elementwise count leaves out: broadcast, reshape, transpose,
# copy, convert, concatenate, pad, iota, constants)
_FREE = {"view", "_unsafe_view", "reshape", "expand", "permute", "transpose", "t",
         "unsqueeze", "squeeze", "flatten", "unflatten", "as_strided", "alias",
         "detach", "lift_fresh", "clone", "_to_copy", "to", "contiguous", "cat",
         "stack", "constant_pad_nd", "pad", "empty", "empty_like", "empty_strided",
         "zeros", "zeros_like", "ones", "ones_like", "full", "full_like", "new_zeros",
         "new_empty", "new_full", "new_ones", "arange", "scalar_tensor", "fill_",
         "zero_", "_local_scalar_dense", "repeat", "view_as_real", "view_as_complex",
         "_reshape_alias", "expand_as", "movedim", "set_", "resize_", "lift",
         "split_copy", "unbind_copy", "_assert_tensor_metadata", "_has_compatible_shallow_copy_type",
         "is_same_size", "sym_size", "sym_stride", "sym_numel", "dim", "sizes"}
_TRANSCENDENTAL = {"exp", "exp2", "tanh", "log", "log2", "rsqrt", "sqrt", "pow",
                   "sigmoid", "sin", "cos", "expm1", "log1p", "silu", "gelu", "erf",
                   "softplus", "_softmax", "_log_softmax", "logsumexp", "reciprocal",
                   "tanh_backward", "sigmoid_backward", "silu_backward", "gelu_backward"}


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _fake(x) -> bool:
    """Any FakeTensor among x's tensors: DTensor's shape propagation."""
    return any(type(t).__name__ == "FakeTensor" for t in _tensors(x))


def _bytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _elems(ts) -> int:
    return sum(t.numel() for t in ts)


@dataclass
class ModuleStats:
    mxu_flops: float = 0.0            # product flops (executed)
    vpu_elems: float = 0.0            # elementwise + reduce output elements
    transcendentals: float = 0.0
    hbm_bytes: float = 0.0            # the pre-fusion rules above
    coll_bytes_by_kind: Dict[str, float] = field(default_factory=dict)
    coll_count_by_kind: Dict[str, int] = field(default_factory=dict)
    opcode_bytes: Dict[str, float] = field(default_factory=dict)

    @property
    def collective_bytes(self) -> float:
        return sum(self.coll_bytes_by_kind.values())

    @property
    def vpu_flops(self) -> float:
        return self.vpu_elems  # ~1 flop per produced element (proxy)


def _traffic(kind: str, operand_bytes: float, result_bytes: float) -> float:
    if kind == "all-gather":
        return max(result_bytes - operand_bytes, 0.0)
    if kind in ("all-reduce", "collective-broadcast"):
        return 2.0 * result_bytes
    if kind == "reduce-scatter":
        return max(operand_bytes - result_bytes, 0.0)
    return operand_bytes


def _site() -> str:
    """The innermost three frames of this package's models and kernels
    (module.function), outermost first: the 'module path' of an op."""
    names, f = [], sys._getframe(2)
    while f is not None and len(names) < 3:
        fn = f.f_code.co_filename.replace("\\", "/")
        if "/repro_torch/" in fn and "/core/hlo.py" not in fn:
            mod = fn.rsplit("/repro_torch/", 1)[1][:-3].replace("/", ".")
            if mod.startswith(("models", "kernels", "train")):
                names.append(f"{mod.split('.')[-1]}.{f.f_code.co_name}")
        f = f.f_back
    return " > ".join(reversed(names)) or "-"


class Counter(TorchDispatchMode):
    """``with Counter() as c: program()`` then ``c.stats`` (a
    ``ModuleStats``), ``c.hbm_bytes_boundary``, ``c.ops`` (aten calls
    counted), ``c.peak_temp_bytes`` (the most bytes the program's own
    results held at once). With ``by_site=True`` it also keeps
    ``c.by_site``: {"hbm" | "flops" | "coll": {"<op> <site>": count}},
    the site the innermost functions of the models and kernels that ran
    the op, for ``launch/inspect_cell``."""

    def __init__(self, by_site: bool = False):
        super().__init__()
        self.stats = ModuleStats(coll_bytes_by_kind=defaultdict(float),
                                 coll_count_by_kind=defaultdict(int),
                                 opcode_bytes=defaultdict(float))
        self.hbm_bytes_boundary = 0.0
        self.ops = 0
        self.mult = 1.0
        self.by_site = ({"hbm": defaultdict(float), "flops": defaultdict(float),
                         "coll": defaultdict(float)} if by_site else None)
        self._live = 0
        self.peak_temp_bytes = 0
        self._ranges = []           # (first, last sequence number, trips) of each loop
        self._quiet = False

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        out = super().__exit__(*exc)
        for d in ("coll_bytes_by_kind", "coll_count_by_kind", "opcode_bytes"):
            setattr(self.stats, d, dict(getattr(self.stats, d)))
        return out

    @contextlib.contextmanager
    def loop(self, trips: float):
        """Count what runs inside ``trips`` times (nested loops multiply),
        and, under autograd, what its backward runs too: the autograd nodes
        made inside carry sequence numbers in a range of their own, and a
        backward op counts ``trips`` times when the node running it lies
        in that range."""
        grad = torch.is_grad_enabled()
        lo = self._seq() if grad else None
        before = self.mult
        self.mult = before * trips
        try:
            yield
        finally:
            self.mult = before
            if grad:
                self._ranges.append((lo, self._seq(), trips))

    def _seq(self) -> int:
        """The autograd sequence number of a node made now (not counted)."""
        self._quiet = True
        try:
            return (torch.zeros((), device="meta", requires_grad=True) * 1).grad_fn._sequence_nr()
        finally:
            self._quiet = False

    def _multiplicity(self) -> float:
        node = torch._C._current_autograd_node() if self._ranges else None
        if node is None:
            return self.mult
        s = node._sequence_nr()
        return self.mult * math.prod(t for lo, hi, t in self._ranges if lo < s < hi)

    def _track(self, outs, ins) -> None:
        for t in outs:
            if t._base is not None or any(t is i for i in ins):
                continue
            nbytes = t.numel() * t.element_size()
            self._live += nbytes
            self.peak_temp_bytes = max(self.peak_temp_bytes, self._live)
            weakref.finalize(t, self._free, nbytes)

    def _free(self, nbytes: int) -> None:
        self._live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t.__name__ == "DTensor" for t in types):
            return NotImplemented       # DTensor runs it; its local ops come back here
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._quiet and not _fake((args, kwargs, out)):
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = func._overloadpacket.__name__
        ns = func.namespace
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        m, st = self._multiplicity(), self.stats
        self.ops += 1
        site = self.by_site is not None and f"{name:24s} {_site()}"
        if ns in ("c10d", "_c10d_functional", "_dtensor") and name in _COLLECTIVE_OPS:
            kind = _COLLECTIVE_OPS[name]
            b = m * _traffic(kind, _bytes(ins), _bytes(outs))
            st.coll_bytes_by_kind[kind] += b
            st.coll_count_by_kind[kind] += int(m)
            if site:
                self.by_site["coll"][site] += b
            return
        if name in _FREE or not outs:
            return
        self._track(outs, ins)
        rb = _bytes(outs)
        st.opcode_bytes[name] += m * rb
        packet = func._overloadpacket
        if packet in flop_registry:
            flops = m * flop_registry[packet](*args, **kwargs, out_val=out)
            st.mxu_flops += flops
            b = _bytes(ins) + rb
            if site:
                self.by_site["flops"][site] += flops
        elif name in _REDUCE or name in _SORT:
            st.vpu_elems += m * _elems(ins[:1])
            b = _bytes(ins[:1]) + rb
            if name in ("_softmax", "_log_softmax"):
                b += _bytes(ins[:1])        # two reductions: the max, the sum
        elif name in _GATHER:
            b = 2 * rb
        elif name in _UPDATE:
            src = ins[1] if len(ins) > 1 and name not in ("select_backward",
                                                         "slice_backward") else ins[0]
            if name in ("index_put", "index_put_"):
                src = ins[-1]
            b = 2 * _bytes([src])
        else:
            st.vpu_elems += m * _elems(outs)
            b = 0
        if name in _TRANSCENDENTAL:
            st.transcendentals += m * _elems(outs)
        st.hbm_bytes += m * b
        if name.endswith("_") or any(t._base is None for t in outs):
            self.hbm_bytes_boundary += m * (_bytes(ins) + rb)   # not a view: a kernel
        if site and b:
            self.by_site["hbm"][site] += m * b

"""``CostCounter``: what stands for XLA's ``cost_analysis`` in the port.

The reference reads the FLOPs of a compiled step from XLA's
HloCostAnalysis. The port compiles nothing, so it counts the aten ops a
call runs instead: a ``TorchDispatchMode`` that sees every op, on
``meta``, CPU or CUDA tensors alike (on meta nothing is allocated and
nothing computed, so a full-width layer is counted from its shapes).

FLOPs, in HloCostAnalysis' conventions, per op:

  * a product (``mm``, ``addmm``, ``bmm``, ``baddbmm``: what ``matmul``
    and ``einsum`` lower to): 2·M·N·K, from ``torch.utils.flop_counter``'s
    registered formulas;
  * an elementwise op, a compare or a select (``where``,
    ``masked_fill``): 1 per output element; a dtype conversion
    (``_to_copy`` to another dtype, XLA's ``convert``) too;
  * a transcendental (``exp``, ``log``, ``rsqrt``, ``sqrt``, ``tanh``,
    ``sigmoid``, ``erf``, ``sin``, ``cos``, a non-integer ``pow``): 1 per
    output element, under ``transcendentals``, not ``flops``, as XLA
    keeps them apart;
  * a fused aten op counts the HLO ops of JAX's spelling of it: ``silu``
    = x·logistic(x), 1 flop and 1 transcendental an element; ``gelu``
    (tanh form) 7 flops and 1 transcendental; ``_softmax`` a max and a sum
    reduction, a subtract and a divide (4 an element, less 2 a row) and
    an exp; ``logsumexp`` a max and a sum reduction, a subtract, an exp,
    and a log, an add and 3 finite-checks a row; an integer ``pow``
    (n - 1) multiplies;
  * a reduction (``sum``, ``mean``, ``amax``, ``max``, ...): 1 per input
    element less 1 per output element (``mean``'s divide: 1 per output);
  * a sort (``sort``, stable ``argsort``): n·log2(n) a sorted row;
    ``searchsorted`` 2·log2(n) a query; ``topk`` 0 (XLA's TopK custom
    call carries no cost);
  * a scatter that adds (``scatter_add``, ``index_add``, an accumulating
    ``index_put``): 1 per added element;
  * data movement (views, ``copy_``, ``clone``, ``cat``, ``stack``,
    gathers, index ops, a same-dtype ``to``, fills, ``arange``): 0.

``flops`` counts the ops the port runs, and only those: its own dtype
conversions (``w.to(h.dtype)``) are in it, under the class ``convert``.

Half precision on XLA's CPU backend, kept apart: the reference's worked
figures come from XLA's CPU backend, which has no bfloat16 arithmetic.
It computes every bf16 op that reads or writes elements (products,
elementwise ops, reductions, gathers, scatters, concatenations; not
views, transposes or copies) in float32: each distinct bf16 operand is
converted to float32 and a bf16 result back, a convert of 1 flop an
element each (measured: a bf16 ``a * b`` of n elements counts 4n, a
bf16 scatter of one row into a cache 2 flops per cache element). Neither
the card nor the reference's TPU target runs these, so they are not in
``flops``: the counter keeps them under the class ``xla_cpu_convert``,
and ``xla_cpu_flops`` = ``flops`` + those converts is the figure to hold
against the reference's CPU ``cost_analysis``. For a decode step, whose
products are matrix-vector, they are 6-50% of that figure on the
reference's 16 x 16 mesh.

Bytes: each op's tensor inputs once plus its outputs (the elements each
addresses: a broadcast dim once), views 0. This is
the **unfused eager traffic** the port moves, op by op, not XLA's fused
"bytes accessed" (a fusion reads its inputs and writes its outputs once).

``by_class`` keeps the totals (``flops``, ``transcendentals``, ``bytes``,
``ops``) per class (``product``, ``elementwise``, ``convert``,
``transcendental``, ``reduction``, ``sort``, ``scatter``, ``movement``,
``view``; and ``xla_cpu_convert``, whose flops only), so a gap against
the reference can be traced to a class. The classes but
``xla_cpu_convert`` add up to ``flops``.

Usage::

    with CostCounter() as cc:
        fn(*args)
    cc.flops, cc.xla_cpu_flops, cc.transcendentals, cc.bytes, cc.by_class
"""
from __future__ import annotations

import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

__all__ = ["CLASSES", "CostCounter", "op_cost", "half_converts",
           "tensors_of"]

CLASSES = ("product", "elementwise", "convert", "transcendental",
           "reduction", "sort", "scatter", "movement", "view",
           "xla_cpu_convert")

#: 1 flop per output element
_ELEMENTWISE = frozenset("""
    add sub rsub mul div neg abs sign reciprocal maximum minimum clamp
    clamp_min clamp_max where masked_fill eq ne lt le gt ge logical_and
    logical_or logical_not logical_xor bitwise_and bitwise_or bitwise_xor
    bitwise_not bitwise_left_shift bitwise_right_shift __lshift__
    __rshift__ remainder fmod floor ceil round trunc floor_divide isinf
    isnan isfinite addcmul addcdiv lerp square
    """.split())
#: 1 transcendental per output element
_TRANSCENDENTAL = frozenset("""
    exp exp2 expm1 log log2 log10 log1p rsqrt sqrt tanh sigmoid erf erfc
    sin cos tan atan atan2 asin acos sinh cosh
    """.split())
#: 1 flop per input element less 1 per output element
_REDUCTION = frozenset("""
    sum mean amax amin max min argmax argmin prod any all nansum
    """.split())
#: these names alias their input (a view, or an in-place view op)
_VIEW = frozenset("""
    view _unsafe_view alias detach t transpose permute expand slice select
    unbind split split_with_sizes squeeze unsqueeze as_strided
    _reshape_alias unfold diagonal narrow reshape view_as expand_as
    lift_fresh movedim chunk
    """.split())


def _name(func) -> str:
    """The op's base name: ``aten.masked_fill_.Scalar`` -> masked_fill."""
    name = func._schema.name.split("::")[-1]
    return name[:-1] if name.endswith("_") and not name.startswith("_") \
        else name


def _numel(x) -> int:
    return x.numel() if isinstance(x, torch.Tensor) else 0


def tensors_of(tree) -> list:
    """The tensors in an op's arguments or results (nested tuples, lists
    and dicts), in order: a plain walk, faster than ``tree_flatten``."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tensors_of(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in tensors_of(x)]
    return []


def _addressed(t: torch.Tensor) -> int:
    """The elements a tensor addresses: a broadcast (stride-0) dim reads
    one element along it, however long it is."""
    return math.prod(n for n, st in zip(t.shape, t.stride()) if st != 0)


def _reduced(args, out_elems: int) -> int:
    src = args[0] if args and isinstance(args[0], torch.Tensor) else None
    return max(0, _numel(src) - out_elems) if src is not None else 0


#: ops that move elements and that XLA's CPU backend still computes in
#: float32 when they are bf16 (its gathers, scatters and concatenations)
_NORMALIZED_MOVES = frozenset("""
    index gather index_select embedding cat stack index_put scatter
    """.split())
_HALF = (torch.bfloat16, torch.float16)


def half_converts(func, cls: str, ins: list, outs: list) -> int:
    """The converts XLA's CPU backend puts around a half-precision op of
    class ``cls`` (``op_cost``'s) with input and output tensors ``ins``
    and ``outs``: the elements of each distinct bf16/f16 operand and of
    each bf16/f16 result (0 for a view, a copy or a convert)."""
    if cls in ("view", "convert") or (cls == "movement"
                                      and _name(func) not in
                                      _NORMALIZED_MOVES):
        return 0
    seen = {id(t): t for t in ins if t.dtype in _HALF}
    return (sum(t.numel() for t in seen.values())
            + sum(t.numel() for t in outs if t.dtype in _HALF))


def op_cost(func, args, kwargs, out) -> tuple:
    """``(class, flops, transcendentals)`` of one aten op call (see the
    module's conventions; XLA's CPU converts apart, in
    :func:`half_converts`)."""
    name = _name(func)
    packet = func.overloadpacket
    outs = tensors_of(out)
    n_out = _numel(outs[0]) if outs else 0
    if packet in flop_registry:
        return "product", int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out)), 0
    if func.is_view or name in _VIEW:
        return "view", 0, 0
    if name == "_to_copy":
        src = args[0]
        same = kwargs.get("dtype", src.dtype) == src.dtype
        return ("movement", 0, 0) if same else ("convert", n_out, 0)
    if name == "copy" and len(args) > 1 and isinstance(args[1],
                                                       torch.Tensor):
        if args[1].dtype != args[0].dtype:
            return "convert", _numel(args[0]), 0
        return "movement", 0, 0
    if name == "pow":
        exp = args[1] if len(args) > 1 else kwargs.get("exponent")
        if isinstance(exp, (int, float)) and float(exp).is_integer() \
                and 1 <= exp <= 8:
            return "elementwise", (int(exp) - 1) * n_out, 0
        return "transcendental", 0, n_out
    if name == "silu":
        return "transcendental", n_out, n_out
    if name == "gelu":
        approx = kwargs.get("approximate", args[1] if len(args) > 1 else
                            "none")
        return "transcendental", (7 if approx == "tanh" else 4) * n_out, \
            n_out
    if name in ("_softmax", "_log_softmax"):
        dim = args[1] % max(args[0].dim(), 1)
        rows = n_out // max(args[0].shape[dim], 1) if args[0].dim() else 1
        return "reduction", 4 * n_out - 2 * rows, n_out
    if name == "logsumexp":
        n_in = _numel(args[0])
        return "reduction", 3 * n_in - 2 * n_out + 4 * n_out, n_in + n_out
    if name in _TRANSCENDENTAL:
        return "transcendental", 0, n_out
    if name in _ELEMENTWISE:
        return "elementwise", n_out, 0
    if name in _REDUCTION:
        flops = _reduced(args, n_out)
        if name == "mean":
            flops += n_out
        return "reduction", flops, 0
    if name == "sort" or name == "argsort":
        src = args[0]
        dim = args[1] if len(args) > 1 and isinstance(args[1], int) else \
            kwargs.get("dim", -1)
        n = src.shape[dim] if src.dim() else 1
        return "sort", int(src.numel() * math.ceil(math.log2(max(n, 2)))), 0
    if name == "searchsorted":
        n = args[0].shape[-1]
        return "sort", int(_numel(args[1]) * 2 * math.ceil(
            math.log2(max(n, 2)))), 0
    if name in ("scatter_add", "index_add", "scatter_reduce"):
        src = args[-1] if isinstance(args[-1], torch.Tensor) else \
            kwargs.get("src")
        return "scatter", _numel(src), 0
    if name == "index_put" and (kwargs.get("accumulate") or (
            len(args) > 3 and args[3])):
        return "scatter", _numel(args[2]), 0
    return "movement", 0, 0


class CostCounter(TorchDispatchMode):
    """Totals of the aten ops run under it (see the module docstring):
    ``flops`` (the port's ops), ``xla_cpu_flops`` (with XLA's CPU
    converts), ``transcendentals``, ``bytes`` (unfused eager traffic) and
    ``by_class``."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.transcendentals = 0
        self.bytes = 0
        self.by_class = {c: {"flops": 0, "transcendentals": 0, "bytes": 0,
                             "ops": 0} for c in CLASSES}

    @property
    def xla_cpu_flops(self) -> int:
        """``flops`` with the converts XLA's CPU backend adds: what the
        reference's CPU ``cost_analysis`` counts."""
        return self.flops + self.by_class["xla_cpu_convert"]["flops"]

    def totals(self) -> dict:
        """``{"flops", "xla_cpu_flops", "transcendentals", "bytes",
        "by_class"}``."""
        return {"flops": self.flops, "xla_cpu_flops": self.xla_cpu_flops,
                "transcendentals": self.transcendentals,
                "bytes": self.bytes,
                "by_class": {c: dict(v) for c, v in self.by_class.items()}}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        cls, flops, trans = op_cost(func, args, kwargs, out)
        ins, outs = tensors_of((args, kwargs)), tensors_of(out)
        converts = half_converts(func, cls, ins, outs)
        n_bytes = 0
        if cls != "view":
            # each input once (an in-place op's output is one of them,
            # read and then written)
            seen = {id(t): t for t in ins}
            n_bytes = sum(_addressed(t) * t.element_size()
                          for t in [*seen.values(), *outs])
        entry = self.by_class[cls]
        entry["flops"] += flops
        entry["transcendentals"] += trans
        entry["bytes"] += n_bytes
        entry["ops"] += 1
        self.by_class["xla_cpu_convert"]["flops"] += converts
        self.flops += flops
        self.transcendentals += trans
        self.bytes += n_bytes
        return out

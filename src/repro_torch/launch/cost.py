"""The meta-device count of a step: the flops and bytes of the dry-run's
architecture cells (``launch/dryrun.py``), which no card holds whole.

``StepCount`` is a ``TorchDispatchMode``. Under it a step runs on
``meta`` tensors (shapes and dtypes, no memory, no arithmetic) and every
aten operator that reaches the dispatcher is counted:

* ``flops``: ``torch.utils.flop_counter``'s formulas, the registry
  ``FlopCounterMode`` reads (products, attention, convolutions; 2 per
  multiply-add). As ``FlopCounterMode`` does, a composite operator that
  reaches the mode unexpanded (``matmul`` under ``inference_mode``) is
  expanded first, and its pieces are counted;
* ``bytes``: each operator's input and output tensor bytes, views and
  allocations (``empty``) excluded. Nothing is fused, so this is an
  upper figure next to XLA's ``bytes accessed``.

Both are for the whole step on one device. The meta kernels of many
operators are Python; so that a step of millions of operators stays
cheap, an operator that returns fresh tensors (no alias, no mutation)
and was seen before with inputs of the same shapes, strides and dtypes
returns empty tensors of the metadata it returned then.

Two kinds of repetition are counted, not traced, by rules that are exact
for the port's code (``fold_time_loops`` and ``count_train_step``; the
tests hold both against the full trace):

* the time-serial loops: ``ssm.slstm_train`` walks its tokens one at a
  time, ``ssm.selective_scan`` its steps in chunks of 64. The count of
  such a call is a polynomial of degree at most 2 in the sequence length
  S (S a multiple of the scan's chunk, at least two chunks): the forwards
  are affine in S; the backwards are quadratic, since the gradient of a
  slice (the sLSTM's ``wx[:, t]``, the scan's chunk ``x[:, lo:lo + 64]``)
  is a full [B, S, ...] tensor, and S (S / 64) of them are summed.
  Under ``fold_time_loops`` each call is traced at four short lengths,
  the quadratic through three of them gives the count at S (the fourth
  must lie on it), and an empty output of the right shape stands
  for the result. In training the sLSTM block is checkpointed as a
  whole, so its count includes the recompute as
  ``torch.utils.checkpoint`` runs it;
* the microbatches: a train step of n > 3 microbatches counts C(2) +
  (C(3) - C(2)) (n - 2), C(m) the same step with m microbatches of the
  same size (every microbatch after the first runs the same operators,
  its gradient accumulation included).
"""
from __future__ import annotations

import contextlib
import dataclasses
from fractions import Fraction

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode


_COMPOSITE = torch._C.DispatchKey.CompositeImplicitAutograd
_ALLOCS = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_like.default,
           torch.ops.aten.empty_strided.default}


def _flat(args, out: list) -> list:
    for a in args:
        if isinstance(a, (list, tuple)):
            _flat(a, out)
        else:
            out.append(a)
    return out


def _meta(t: torch.Tensor) -> tuple:
    return tuple(t.shape), t.stride(), t.dtype


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


class StepCount(TorchDispatchMode):
    """Counts ``flops`` and ``bytes`` of the aten operators run under it
    (module docstring). ``add`` adds counts from elsewhere; while
    ``paused`` nothing is counted."""

    def __init__(self):
        super().__init__()
        self.registry = FlopCounterMode(display=False).flop_registry
        self.flops = 0
        self.bytes = 0
        self.paused = False
        self._cache: dict = {}
        self._info: dict = {}

    def add(self, flops: int, nbytes: int) -> None:
        self.flops += flops
        self.bytes += nbytes

    def _func_info(self, func) -> tuple:
        s = func._schema
        fresh = not (any(a.alias_info is not None for a in s.arguments)
                     or any(r.alias_info is not None for r in s.returns))
        counted = func._overloadpacket in self.registry
        info = (func.is_view or func in _ALLOCS, fresh, counted,
                not counted and func.has_kernel_for_dispatch_key(_COMPOSITE))
        self._info[func] = info
        return info

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.paused:
            return func(*args, **kwargs)
        skip, fresh, counted, composite = (self._info.get(func)
                                           or self._func_info(func))
        if composite:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        if skip:
            return func(*args, **kwargs)
        flat = _flat(args, [])
        if kwargs:
            flat = _flat(kwargs.values(), flat)
        out = key = None
        if fresh:
            key = tuple([func] + [_meta(a) if isinstance(a, torch.Tensor)
                                  else a for a in flat])
            try:
                hit = self._cache.get(key)
            except TypeError:            # an unhashable argument
                key = hit = None
            if hit is not None:
                many, metas = hit
                outs = [torch.empty_strided(m[0], m[1], dtype=m[2],
                                            device="meta")
                        if m is not None else v for m, v in metas]
                out = tuple(outs) if many else outs[0]
        if out is None:
            out = func(*args, **kwargs)
            if key is not None:
                many = isinstance(out, tuple)
                outs = out if many else (out,)
                if all(isinstance(t, torch.Tensor) and t.is_meta
                       or not isinstance(t, (torch.Tensor, list, tuple))
                       for t in outs):
                    self._cache[key] = (many, [
                        (_meta(t), None) if isinstance(t, torch.Tensor)
                        else (None, t) for t in outs])
        outs = out if isinstance(out, (list, tuple)) else (out,)
        self.bytes += sum(map(_nbytes, flat)) + sum(map(_nbytes, outs))
        if counted:
            self.flops += self.registry[func._overloadpacket](
                *args, **kwargs, out_val=out)
        return out


def count(fn, *args, **kwargs) -> tuple:
    """(flops, bytes, output) of ``fn(*args, **kwargs)`` on meta tensors,
    with the time-serial loops folded."""
    counter = StepCount()
    with counter, fold_time_loops(counter):
        out = fn(*args, **kwargs)
    return counter.flops, counter.bytes, out


# ------------------------------------------------------------ time loops

class _Folded(torch.autograd.Function):
    """An empty output standing for a folded call: its forward and
    backward add the call's counts; its input gradients are empty."""

    @staticmethod
    def forward(ctx, counter, fwd, bwd, out_meta, *inputs):
        ctx.counter, ctx.bwd = counter, bwd
        ctx.inputs = [(t.shape, t.dtype) for t in inputs]
        counter.add(*fwd)
        counter.paused = True
        try:
            return torch.empty(out_meta[0], dtype=out_meta[1], device="meta")
        finally:
            counter.paused = False

    @staticmethod
    def backward(ctx, grad):
        counter = ctx.counter
        counter.add(*ctx.bwd)
        counter.paused = True
        try:
            grads = [torch.empty(s, dtype=d, device="meta") if need else None
                     for (s, d), need in zip(ctx.inputs,
                                             ctx.needs_input_grad[4:])]
        finally:
            counter.paused = False
        return (None, None, None, None, *grads)


def _short(t: torch.Tensor, s: int, seq_dim: int = 1) -> torch.Tensor:
    shape = list(t.shape)
    shape[seq_dim] = s
    out = torch.empty(shape, dtype=t.dtype, device="meta")
    return out.requires_grad_(t.requires_grad)


def _fresh(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype,
                       device="meta").requires_grad_(t.requires_grad)


def _trace(call, inputs: list, grad: bool, remat: bool) -> tuple:
    """(forward counts, backward counts, output) of ``call()`` on the short
    ``inputs``: the forward alone, then in ``grad`` mode the forward and
    backward (through ``torch.utils.checkpoint`` when ``remat``: the
    recompute is counted in the backward) minus the forward. Identity
    saved-tensor hooks shield the trace from an enclosing checkpoint."""
    with torch.autograd.graph.saved_tensors_hooks(lambda t: t, lambda t: t):
        c = StepCount()
        with c, torch.set_grad_enabled(grad):
            out = call()
        fwd = (c.flops, c.bytes)
        bwd = (0, 0)
        need = [t for t in inputs if t.requires_grad]
        if grad and need:
            c = StepCount()
            with c, torch.enable_grad():
                if remat:
                    from torch.utils.checkpoint import checkpoint
                    out = checkpoint(call, use_reentrant=False)
                else:
                    out = call()
                torch.autograd.grad(out, need, torch.empty_like(out))
            bwd = (c.flops - fwd[0], c.bytes - fwd[1])
    return fwd, bwd, out


def _fit(counts: list, lengths: tuple, s: int) -> tuple:
    """The counts at ``s`` from the quadratic through the first three
    (``lengths``, exact in rationals); raises unless the fourth lies on
    it too."""
    def at(x, i):
        total = Fraction(0)
        for j, (xj, cj) in enumerate(zip(lengths[:3], counts[:3])):
            term = Fraction(cj[i])
            for k, xk in enumerate(lengths[:3]):
                if k != j:
                    term *= Fraction(x - xk, xj - xk)
            total += term
        return total

    out = []
    for i in range(2):
        if at(lengths[3], i) != counts[3][i]:
            raise AssertionError(f"a folded loop's count is not quadratic "
                                 f"in its length: {counts} at {lengths}")
        value = at(s, i)
        if value.denominator != 1:
            raise AssertionError(f"a folded loop's count at {s} is not whole")
        out.append(int(value))
    return tuple(out)


class _Folder:
    """The stand-ins ``fold_time_loops`` installs, with their counts
    memoized by the call's shapes, dtypes and modes."""

    def __init__(self, counter: StepCount, lengths: dict):
        self.counter, self.lengths, self.memo = counter, lengths, {}

    def call(self, name: str, s: int, tensors: list, seq: tuple, rebuild,
             remat: bool):
        """``tensors`` are the call's tensor inputs, ``seq`` flags the ones
        whose dim 1 is the sequence; ``rebuild(tensors)`` calls the real
        function on (short) tensors in that order."""
        lengths = self.lengths[name]
        grad = torch.is_grad_enabled() and any(t.requires_grad
                                               for t in tensors)
        key = (name, s, grad, remat, tuple(
            (tuple(t.shape), t.dtype, t.requires_grad) for t in tensors))
        if key not in self.memo:
            self.counter.paused = True
            try:
                traces = []
                for ls in lengths:
                    short = [_short(t, ls) if cut else _fresh(t)
                             for t, cut in zip(tensors, seq)]
                    traces.append(_trace(lambda: rebuild(short), short,
                                         grad, remat))
            finally:
                self.counter.paused = False
            out = traces[0][2]
            if not out.is_contiguous():
                raise AssertionError(f"{name}: a non-contiguous output")
            shape = list(out.shape)
            shape[1] = s
            self.memo[key] = (_fit([t[0] for t in traces], lengths, s),
                              _fit([t[1] for t in traces], lengths, s),
                              (tuple(shape), out.dtype))
        fwd, bwd, out_meta = self.memo[key]
        return _Folded.apply(self.counter, fwd, bwd, out_meta, *tensors)


@contextlib.contextmanager
def fold_time_loops(counter: StepCount):
    """Count ``ssm.slstm_train`` and ``ssm.selective_scan`` by the
    quadratic rule of the module docstring while the context is open, on
    meta tensors whose sequence is longer than the fourth short length
    (and, for the scan, a multiple of its chunk of 64); other calls run as
    they are."""
    from repro_torch.models import ssm

    slstm, scan = ssm.slstm_train, ssm.selective_scan
    folder = _Folder(counter, {"slstm": (2, 3, 4, 5),
                               "scan": (128, 192, 256, 320)})

    def slstm_train(p, cfg, x):
        s = x.shape[1]
        if not x.is_meta or s <= 5:
            return slstm(p, cfg, x)
        names = sorted(p)

        def rebuild(ts):
            return slstm(dict(zip(names, ts[1:])), cfg, ts[0])

        # the xLSTM checkpoints the whole sLSTM block (layers.remat)
        remat = torch.is_grad_enabled() and cfg.remat
        return folder.call("slstm", s, [x, *[p[k] for k in names]],
                           (True,) + (False,) * len(names), rebuild, remat)

    def selective_scan(x, dt, a, bm, cm, chunk: int = 64):
        s = x.shape[1]
        if not x.is_meta or s <= 320 or s % chunk or chunk != 64:
            return scan(x, dt, a, bm, cm, chunk)

        def rebuild(ts):
            return scan(*ts, chunk)

        # dt, bm and cm are cut with x; a keeps its shape
        return folder.call("scan", s, [x, dt, a, bm, cm],
                           (True, True, False, True, True), rebuild, False)

    ssm.slstm_train, ssm.selective_scan = slstm_train, selective_scan
    try:
        yield folder
    finally:
        ssm.slstm_train, ssm.selective_scan = slstm, scan


# ----------------------------------------------------------- train step

def count_train_step(cfg, shape, opt_cfg, fold: bool = True) -> tuple:
    """(flops, bytes, output) of one ``make_train_step(cfg, opt_cfg)`` call
    on the cell's batch, on meta tensors; with ``fold`` and n > 3
    microbatches, the counts by the microbatch rule of the module
    docstring (the output is the 3-microbatch step's: the same trees)."""
    n = max(cfg.microbatches, 1)
    if not fold or n <= 3:
        return _count_train(cfg, shape.global_batch, shape.seq_len, opt_cfg)
    per = shape.global_batch // n
    c2, c3 = (_count_train(dataclasses.replace(cfg, microbatches=m), m * per,
                           shape.seq_len, opt_cfg) for m in (2, 3))
    return (*(b + (c - b) * (n - 2) for b, c in zip(c2[:2], c3[:2])), c3[2])


def _count_train(cfg, batch: int, seq: int, opt_cfg) -> tuple:
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.model import input_specs, params_specs
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_step import make_train_step

    params = params_specs(cfg)
    opt = adamw_init(params, opt_cfg)
    batch_t = input_specs(cfg, ShapeConfig("count", seq, batch, "train"))
    return count(make_train_step(cfg, opt_cfg), params, opt, batch_t)

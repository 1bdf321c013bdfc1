"""Pipeline fusion: collapse Filter/Project chains into one step.

Counterpart of ``velox_tpu/exec/fuse.py``. A scan-filter -> project ->
filter ... chain collapses into one ``FusedChain``: a conjunction of all
filters and the final projections, both rewritten onto the source's
columns. ``chain_fn`` evaluates it over a batch in one ``ExprSet`` pass
per part, so intermediate projections are never materialized. The port
runs eagerly: there is no compiled-program cache.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from velox_tpu_torch import types as T
from velox_tpu_torch.common.process_trace import spanned
from velox_tpu_torch.core import expressions as ex
from velox_tpu_torch.core import plan as P
from velox_tpu_torch.expression.eval import ExprSet
from velox_tpu_torch.vector.device import DeviceBatch


def substitute(e: ex.TypedExpr,
               mapping: Dict[str, ex.TypedExpr]) -> ex.TypedExpr:
    """Replace FieldAccess nodes by the producing expressions (inlining)."""
    if isinstance(e, ex.FieldAccess):
        return mapping.get(e.name, e)
    if isinstance(e, ex.Call):
        args = tuple(substitute(a, mapping) for a in e.args)
        if args == e.args:
            return e
        return ex.Call(e.dtype, e.name, args)
    if isinstance(e, ex.Cast):
        child = substitute(e.child, mapping)
        if child is e.child:
            return e
        return ex.Cast(e.dtype, child, is_try=e.is_try)
    return e


class FusedChain:
    """A collapsed Filter/Project chain over a source plan node.

    predicate: conjunction of all filters (rewritten to source columns);
    names/exprs: final output projections (rewritten to source columns).
    """

    def __init__(self, source: P.PlanNode,
                 predicate: Optional[ex.TypedExpr],
                 names: List[str], exprs: List[ex.TypedExpr]):
        self.source = source
        self.predicate = predicate
        self.names = names
        self.exprs = exprs

    @property
    def is_identity(self) -> bool:
        if self.predicate is not None:
            return False
        st = self.source.output_type()
        return (list(self.names) == list(st.names)
                and all(isinstance(e, ex.FieldAccess) and e.name == n
                        for n, e in zip(self.names, self.exprs)))


def collapse_chain(node: P.PlanNode) -> FusedChain:
    """Collapse the longest Filter/Project(/scan-filter) chain ending at
    `node` into one FusedChain. AND-combined filters are evaluated against
    the values visible at their own position (correct under inlining
    because projections are pure)."""
    if isinstance(node, P.FilterNode):
        inner = collapse_chain(node.source)
        mapping = dict(zip(inner.names, inner.exprs))
        pred = substitute(node.predicate, mapping)
        if inner.predicate is not None:
            pred = ex.Call(T.BOOLEAN, "and", (inner.predicate, pred))
        return FusedChain(inner.source, pred, inner.names, inner.exprs)
    if isinstance(node, P.ProjectNode):
        inner = collapse_chain(node.source)
        mapping = dict(zip(inner.names, inner.exprs))
        exprs = [substitute(e, mapping) for e in node.expressions]
        return FusedChain(inner.source, inner.predicate,
                          list(node.names), exprs)
    if isinstance(node, P.TableScanNode) and node.filter is not None:
        st = node.output_type()
        names = list(st.names)
        exprs = [ex.field(n, t) for n, t in zip(st.names, st.children)]
        # strip the filter from the scan node: it is now part of the chain;
        # the scan keeps it as ``prune_filter`` to prune its splits
        bare = dataclasses.replace(node, filter=None)
        object.__setattr__(bare, "prune_filter", node.filter)
        return FusedChain(bare, node.filter, names, exprs)
    st = node.output_type()
    names = list(st.names)
    exprs = [ex.field(n, t) for n, t in zip(st.names, st.children)]
    return FusedChain(node, None, names, exprs)


def chain_fn(chain: FusedChain):
    """DeviceBatch -> DeviceBatch function for a FusedChain.

    The predicate evaluates on all active rows and its errors count;
    projections count errors only on rows that pass (velox FilterProject
    error semantics). The output batch carries the running error count.
    """

    @spanned("chain")
    def fn(batch: DeviceBatch) -> DeviceBatch:
        mask = batch.mask
        err = torch.zeros((batch.capacity,), dtype=torch.bool,
                          device=batch.device)
        if chain.predicate is not None:
            sink = []
            f = ExprSet([chain.predicate], None).eval_batch(
                batch, err_sink=sink)[0]
            if sink[0] is not None:
                err = err | (sink[0] & mask)
            passed = f.full_data(batch.capacity).to(torch.bool)
            if f.validity is not None:
                passed = passed & f.full_validity(batch.capacity)
            mask = mask & passed
        sink = []
        vals = ExprSet(list(chain.exprs), None).eval_batch(
            batch, err_sink=sink)
        if sink[0] is not None:
            err = err | (sink[0] & mask)
        cols = {name: v.to_column(batch.capacity)
                for name, v in zip(chain.names, vals)}
        n_err = err.sum(dtype=torch.int32)
        if batch.errors is not None:
            n_err = n_err + batch.errors
        return DeviceBatch(cols, mask, errors=n_err)

    return fn

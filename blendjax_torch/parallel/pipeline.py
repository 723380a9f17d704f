"""Pipeline parallelism: GPipe microbatch pipelining over a mesh axis
(port of ``blendjax/parallel/pipeline.py``).

One process per card: the rank at position ``s`` of the ``pipe`` axis
runs stage ``s`` on its slice ``[s]`` of the stacked parameters. The
schedule is the reference's: tick ``t`` runs microbatch ``m = t - s`` on
stage ``s``, and the pipeline drains after ``M + S - 1`` ticks (bubble
fraction ``(S - 1) / (M + S - 1)``). Each tick sends the stage's output
to stage ``s + 1`` with ``batch_isend_irecv`` on the ``pipe`` group. The
reference computes every tick on every stage and masks the idle ones; a
stage here runs, sends and receives only on the ticks where it holds a
real microbatch, so the sends and receives pair up and nothing is wasted.

Point-to-point ops carry no gradient, so the schedule is one
``torch.autograd.Function`` (:class:`_Pipeline`): its forward builds each
microbatch's local autograd graph of the stage, and its backward runs the
schedule in reverse, sending each input's gradient to stage ``s - 1``
(the pattern of :mod:`blendjax_torch.parallel.ring`). Only the last
stage's outputs count; an all-reduce-sum of ``out * mask`` over the axis
replicates them, as the reference's ``psum``.

Gradients: the input ``x`` is replicated over the axis, so its gradient
is the sum over the stages (stage 0's, on every rank). The stacked
parameters' gradient holds this rank's stage in slice ``[s]`` and zeros
elsewhere: each rank updates its own stage.

A module becomes a stage function through :func:`torch.func.functional_call`
over a stacked dict of its parameters::

    stacked = stack_stage_params(
        [dict(b.named_parameters()) for b in blocks])

    def stage_fn(params, x):
        return torch.func.functional_call(blocks[0], params, (x,))

    y = pipeline_apply(stage_fn, stacked, x, mesh, axis="pipe")

(``torch.stack`` keeps the stack on the blocks' parameters in the
autograd graph, so their ``.grad`` fill on backward.)
"""

from __future__ import annotations

import torch

from blendjax_torch.parallel.collectives import _all_reduce, _key, _nbytes, _record
from blendjax_torch.parallel.mesh import axes_group, axes_index, mesh_shape


def stack_stage_params(stage_params: list) -> dict:
    """Stack per-stage parameter dicts (nested dicts of tensors, one per
    stage, all of one structure) along a new leading dim of size
    ``len(stage_params)``."""
    first = stage_params[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([sp[k] for sp in stage_params])
                for k in first}
    return torch.stack(list(stage_params))


def _flatten(tree, prefix=()) -> list:
    if isinstance(tree, dict):
        out = []
        for k in tree:
            out += _flatten(tree[k], prefix + (k,))
        return out
    return [(prefix, tree)]


def _unflatten(items) -> dict:
    out: dict = {}
    for keys, v in items:
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return out


def _exchange(mesh, axis, group, sends, recvs) -> None:
    """Post ``sends`` ``[(tensor, stage)]`` and ``recvs`` ``[(buffer,
    stage)]`` on the axis's group as one batch and wait for them."""
    import torch.distributed as dist

    ops = [dist.P2POp(dist.isend, t.contiguous(),
                      dist.get_global_rank(group, peer), group=group)
           for t, peer in sends]
    ops += [dist.P2POp(dist.irecv, t, dist.get_global_rank(group, peer),
                       group=group) for t, peer in recvs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for t, _peer in sends:
        _record("collective-permute", _key(mesh, axis), _nbytes(t))


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, keys, mesh, axis, x, *leaves):
        n_stages = mesh_shape(mesh)[axis]
        s = axes_index(mesh, axis)
        group = axes_group(mesh, axis)
        needs = any(ctx.needs_input_grad[4:])
        params = [leaf[s].detach().requires_grad_(leaf.requires_grad)
                  for leaf in leaves]
        tree = _unflatten(zip(keys, params))
        m_total = int(x.shape[0])
        mb_shape, dtype = tuple(x.shape[1:]), x.dtype
        outs = torch.zeros_like(x)
        saved: dict = {}
        buf = None
        for t in range(m_total + n_stages - 1):
            m = t - s
            sends = []
            if 0 <= m < m_total:
                inp = (x[m] if s == 0 else buf).detach()
                inp.requires_grad_(needs and (s > 0 or x.requires_grad))
                with torch.set_grad_enabled(needs):
                    y = stage_fn(tree, inp)
                if tuple(y.shape) != mb_shape or y.dtype != dtype:
                    raise ValueError(
                        "pipeline stages must preserve the microbatch's shape "
                        f"and dtype (the activation buffer is reused): stage "
                        f"maps {mb_shape} {dtype} -> {tuple(y.shape)} "
                        f"{y.dtype}")
                if needs:
                    saved[m] = (inp, y)
                if s == n_stages - 1:
                    outs[m] = y.detach()
                else:
                    sends.append((y.detach(), s + 1))
            recvs = []
            if s > 0 and 0 <= t + 1 - s < m_total:
                buf = torch.empty(mb_shape, dtype=dtype, device=x.device)
                recvs.append((buf, s - 1))
            _exchange(mesh, axis, group, sends, recvs)
        ctx.stage_fn = stage_fn
        ctx.args = (mesh, axis, n_stages, s, m_total)
        ctx.saved = saved
        ctx.params = params
        ctx.leaf_meta = [(leaf.shape, leaf.dtype) for leaf in leaves]
        mask = 1.0 if s == n_stages - 1 else 0.0
        return _all_reduce(outs * mask, mesh, axis)

    @staticmethod
    def backward(ctx, g_out):
        mesh, axis, n_stages, s, m_total = ctx.args
        group = axes_group(mesh, axis)
        params, saved = ctx.params, ctx.saved
        want = [p for p in params if p.requires_grad]
        g_params = [torch.zeros_like(p) for p in want]
        x_grad = ctx.needs_input_grad[4]
        g_x = torch.zeros_like(g_out) if x_grad else None
        g_buf = None
        for t in reversed(range(m_total + n_stages - 1)):
            m = t - s
            sends = []
            if 0 <= m < m_total:
                inp, y = saved.pop(m)
                gy = g_out[m] if s == n_stages - 1 else g_buf
                wrt = ([inp] if inp.requires_grad else []) + want
                if y.requires_grad and wrt:
                    gs = torch.autograd.grad(y, wrt, gy, allow_unused=True)
                else:
                    gs = [None] * len(wrt)
                if inp.requires_grad:
                    g_inp, gs = gs[0], gs[1:]
                    if g_inp is None:
                        g_inp = torch.zeros_like(inp)
                    if s > 0:
                        sends.append((g_inp, s - 1))
                    elif g_x is not None:
                        g_x[m] = g_inp
                for acc, g in zip(g_params, gs):
                    if g is not None:
                        acc.add_(g)
            recvs = []
            if s < n_stages - 1 and 0 <= t - 1 - s < m_total:
                g_buf = torch.empty_like(g_out[0])
                recvs.append((g_buf, s + 1))
            _exchange(mesh, axis, group, sends, recvs)
        ctx.saved = ctx.params = None
        if g_x is not None:
            # x is replicated over the axis: its gradient is the sum over
            # the stages, stage 0's
            g_x = _all_reduce(g_x, mesh, axis)
        leaf_grads, it = [], iter(g_params)
        for p, (shape, dtype) in zip(params, ctx.leaf_meta):
            if not p.requires_grad:
                leaf_grads.append(None)
                continue
            full = torch.zeros(shape, dtype=dtype, device=p.device)
            full[s] = next(it)
            leaf_grads.append(full)
        return (None, None, None, None, g_x, *leaf_grads)


def pipeline_apply(stage_fn, stacked_params, x, mesh, axis: str = "pipe"):
    """Run ``x`` through the ``n_stages`` copies of ``stage_fn`` pipelined
    over mesh axis ``axis``.

    - ``stage_fn``: ``(params, microbatch) -> microbatch``, the same code
      for every stage, which must preserve the microbatch's shape and
      dtype (the activation buffer is reused);
    - ``stacked_params``: a (nested) dict of tensors whose leading dim is
      the size of ``axis`` (:func:`stack_stage_params`); rank ``s`` of the
      axis runs slice ``[s]``;
    - ``x``: ``(num_microbatches, microbatch, ...)``, the same on every
      rank of ``axis``. On a mesh with a batch axis each rank passes its
      rows of the microbatch dim (the rows the feeder gives it), so
      ``pipe x data`` composes without a gather. The reference's
      ``batch_axis=`` names that axis for its ``shard_map``; here ``x`` is
      always this rank's rows, so there is no such parameter.

    Returns the ``(num_microbatches, microbatch, ...)`` outputs, replicated
    over ``axis``. Without ``axis`` on the mesh the stages run one after
    another on this rank. A stage count other than the axis size raises
    ``ValueError``."""
    items = _flatten(stacked_params)
    keys = [k for k, _ in items]
    leaves = [v for _, v in items]
    if not leaves:
        raise ValueError("stacked_params holds no tensor")
    shape = mesh_shape(mesh)
    if axis not in shape:
        n = int(leaves[0].shape[0])
        y = x
        for i in range(n):
            p_i = _unflatten((k, v[i]) for k, v in items)
            y = torch.stack([stage_fn(p_i, y[m]) for m in range(y.shape[0])])
        return y
    n_stages = shape[axis]
    for k, leaf in items:
        if int(leaf.shape[0]) != n_stages:
            raise ValueError(
                f"stacked_params leaf {'/'.join(map(str, k))} has leading dim "
                f"{int(leaf.shape[0])}, not the {n_stages} stages of mesh "
                f"axis {axis!r}: one stage slice per rank of the axis")
    return _Pipeline.apply(stage_fn, keys, mesh, axis, x, *leaves)


__all__ = ["pipeline_apply", "stack_stage_params"]

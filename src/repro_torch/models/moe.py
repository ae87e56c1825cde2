"""Mixture-of-Experts MLP with capacity-based scatter dispatch.

Port of `repro.models.moe` (lines 22-83): the router's softmax, the top-k
experts of each token with their renormalised weights, the Switch
load-balance loss, then capacity-based dispatch. A token's slot in an
expert is its rank among the (token, choice) pairs that picked that
expert, in flattened (token, choice) order (the cumsum of the one-hot);
pairs ranked at or past the capacity C are dropped, exactly where the
reference drops them. Kept pairs are scattered into (E, C, D) buffers
(`index_put_(accumulate=True)`: every kept pair owns its slot, a dropped
one adds zeros to slot C - 1), the experts run as batched products, and
each token gathers its kept pairs back, weighted. Like the reference,
the expert products are plain matmuls, outside any kernel.

Top-k breaks ties as `lax.top_k` does, the lower expert index first: a
stable descending sort, since `torch.topk`'s tie order is unspecified.

Under autograd the layer is differentiable exactly where the
reference's is: through the router's softmax into the top-k weights
and the aux loss's mean probabilities, the expert GEMMs, the scatter
and the gather. The expert indices, ranks, kept mask and the aux
loss's dispatch fractions `ce` are integers or built from them and
carry no gradient. The scatter's backward is a gather, and the
gather's backward adds into the (E, C, D) buffer only at kept pairs'
own slots and zeros at dropped ones, so it is deterministic.

`moe_layer.tap`, None by default, is called with each call's capacity
and kept mask (a bool tensor over the flattened (token, choice) pairs)
when set, for a caller that counts drops. `moe_layer.route`, None by
default, is called with each call's chosen experts (T, k) and the
router's probabilities (T, E) and returns the experts to use, whose
probabilities then weigh them: a checker records one run's routing and
replays it in another whose sums are rounded otherwise (a split over
ranks), so a near-tie broken the other way does not hide what it
compares. Returning its argument changes nothing.

`moe_layer_sharded` (reference lines 86-135), which every MoE block
calls, is `moe_layer` under the mesh pinned with
`distributed.shardctx.sharding_rules`. Without a mesh, or on a mesh
without batch axes ("pod", "data"), it is `moe_layer`. Otherwise the
dispatch stays inside each data shard and the experts' d_ff is split
over "model": every rank runs `moe_layer` on its rows with its d_ff
slice of `up`, `gate` and `down`, the capacity taken from its own token
count, then SUMs `out` over "model" (the down-projection's contraction
over d_ff, in `out`'s dtype, as `psum` sums) and averages `aux` over
the batch axes, each an all-reduce on the mesh's sub-group
(`shardctx.all_reduce`, counted in `shardctx.COLLECTIVES`). x is either

  * a plain tensor: this rank's rows (the batch split over the batch
    axes, as the plans place it); the expert weights are then this
    rank's d_ff slices (`launch.sharding.shard_params` cuts them under
    the plan), or DTensors; or
  * a `DTensor`: the whole batch laid out over the mesh, with plain
    weights the full experts on every rank. A batch the batch axes do
    not divide runs `moe_layer` whole, as the reference falls back; the
    output comes back a DTensor over the same mesh.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.shardctx import all_reduce, axis_size, axis_sizes, \
    batch_axes, current, local_range, placements
from .layers import apply_act, dense_init


def moe_params(gen, d: int, f: int, n_experts: int, glu: bool,
               dtype=torch.bfloat16):
    p = {"router": dense_init(gen, (d, n_experts), dtype=torch.float32),
         "up": dense_init(gen, (n_experts, d, f), dtype=dtype),
         "down": dense_init(gen, (n_experts, f, d), dtype=dtype)}
    if glu:
        p["gate"] = dense_init(gen, (n_experts, d, f), dtype=dtype)
    return p


def moe_layer(x, p, *, top_k: int, capacity_factor: float,
              act: str = "silu", glu: bool = True, no_drop: bool = False):
    """x: (..., D) -> (out (..., D) in x's dtype, aux load-balance loss, a
    float32 scalar). no_drop=True sets the capacity to the token count, so
    no pair is dropped (decode)."""
    shape = x.shape
    D = shape[-1]
    x2 = x.reshape(-1, D)
    T = x2.shape[0]
    E = p["router"].shape[1]
    k = top_k

    probs = torch.softmax(x2.float() @ p["router"], dim=-1)      # (T, E)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :k], idx[:, :k]
    if moe_layer.route is not None:
        idx = moe_layer.route(idx, probs)
        w = probs.gather(1, idx)
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)

    # Switch-style load-balance loss: E * sum_e f_e * P_e
    me = probs.mean(0)
    ce = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
        0, idx.reshape(-1), torch.ones(T * k, device=x.device)) / (T * k)
    aux = E * (me * ce).sum()

    C = T if no_drop else max(1, int(capacity_factor * k * T / E))
    flat_e = idx.reshape(-1)                                     # (T*k,)
    # the cumsum runs along the contiguous axis of the (E, T*k) one-hot:
    # along the (T*k, E) one's long axis a GPU scans each of the E columns
    # serially
    pos_in_e = F.one_hot(flat_e, E).t().contiguous().cumsum(1).gather(
        0, flat_e[None])[0] - 1
    kept = pos_in_e < C
    if moe_layer.tap is not None:
        moe_layer.tap(capacity=C, kept=kept)
    keep = kept.to(x2.dtype)
    slot = pos_in_e.clamp(0, C - 1)

    x_rep = x2.repeat_interleave(k, dim=0)                       # (T*k, D)
    buf = torch.zeros((E, C, D), dtype=x2.dtype, device=x.device)
    buf.index_put_((flat_e, slot), x_rep * keep[:, None], accumulate=True)

    up = torch.bmm(buf, p["up"])
    if glu:
        h = apply_act(torch.bmm(buf, p["gate"]), act) * up
    else:
        h = apply_act(up, act)
    out_buf = torch.bmm(h, p["down"])                            # (E, C, D)

    y = out_buf[flat_e, slot] * (keep * w.reshape(-1).to(x2.dtype))[:, None]
    return y.view(T, k, D).sum(1).reshape(shape), aux


moe_layer.tap = None
moe_layer.route = None


# the d_ff dimension of each expert weight, split over "model"
_FF_DIM = {"up": 2, "gate": 2, "down": 1}


def _to_local(p, mesh, full: bool):
    """This rank's expert weights: DTensors redistributed to the d_ff
    split and read locally; plain ones cut to this rank's d_ff share
    (`full`) or as they are."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    out = {}
    for k, w in p.items():
        if isinstance(w, DTensor):
            pl = [Replicate()] * mesh.ndim
            if k in _FF_DIM and "model" in mesh.mesh_dim_names:
                pl[mesh.mesh_dim_names.index("model")] = Shard(_FF_DIM[k])
            w = w.redistribute(mesh, pl).to_local()
        elif full and k in _FF_DIM:
            f = w.shape[_FF_DIM[k]]
            lo, hi = local_range(f, f // axis_size("model", mesh))
            w = w.narrow(_FF_DIM[k], lo, hi - lo)
        out[k] = w
    return out


def moe_layer_sharded(x, p, *, top_k: int, capacity_factor: float,
                      act: str = "silu", glu: bool = True,
                      no_drop: bool = False):
    """`moe_layer` under the pinned mesh (module docstring): the same
    (out, aux)."""
    kw = dict(top_k=top_k, capacity_factor=capacity_factor, act=act,
              glu=glu, no_drop=no_drop)
    mesh = current()
    ba = batch_axes(mesh) if mesh is not None else ()
    if not ba:
        return moe_layer(x, p, **kw)
    from torch.distributed.tensor import DTensor, Replicate
    sizes = axis_sizes(mesh)
    nb = 1
    for a in ba:
        nb *= sizes[a]
    p = {k: p[k] for k in ("router", "up", "down", "gate")
         if k != "gate" or glu}
    whole = isinstance(x, DTensor)
    if whole and x.shape[0] % nb:
        full = {k: w.full_tensor() if isinstance(w, DTensor) else w
                for k, w in p.items()}
        out, aux = moe_layer(x.full_tensor(), full, **kw)
        return (DTensor.from_local(out, mesh, [Replicate()] * mesh.ndim),
                aux)
    rows_pl = placements((ba,) + ((),) * (x.dim() - 1), mesh)
    xl = x.redistribute(mesh, rows_pl).to_local() if whole else x
    out, aux = moe_layer(xl, _to_local(p, mesh, full=whole), **kw)
    if sizes.get("model", 1) > 1:
        all_reduce(out, "model")
    aux = aux.reshape(1)
    for a in ba:
        if sizes[a] > 1:
            all_reduce(aux, a)
    aux = aux[0] / nb
    if whole:
        out = DTensor.from_local(out, mesh, rows_pl)
    return out, aux

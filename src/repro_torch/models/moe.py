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

`moe_layer_sharded` (reference lines 86-135) is the same function under
a device mesh; `moe_layer(mesh=...)` refuses it, naming ROADMAP queue 1
items 7 and 8. `moe_layer.tap`, None by default, is called with each
call's capacity and kept mask (a bool tensor over the flattened
(token, choice) pairs) when set, for a caller that counts drops.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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
              act: str = "silu", glu: bool = True, no_drop: bool = False,
              mesh=None):
    """x: (..., D) -> (out (..., D) in x's dtype, aux load-balance loss, a
    float32 scalar). no_drop=True sets the capacity to the token count, so
    no pair is dropped (decode)."""
    if mesh is not None:
        raise NotImplementedError(
            "moe_layer(mesh=...): the expert-sharded MoE under a device "
            "mesh is not ported yet (ROADMAP queue 1, items 7 and 8); pass "
            "mesh=None")
    shape = x.shape
    D = shape[-1]
    x2 = x.reshape(-1, D)
    T = x2.shape[0]
    E = p["router"].shape[1]
    k = top_k

    probs = torch.softmax(x2.float() @ p["router"], dim=-1)      # (T, E)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :k], idx[:, :k]
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

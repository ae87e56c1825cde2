"""Shared layers: init, norms, RoPE, (gated) MLPs, the embedding lookup
and the chunked cross-entropy loss.

Port of `repro.models.layers` (lines 19-183; `sinusoidal_pos`, the
encoder-decoder's position table, lines 79-88). Parameters are plain
tensors in nested dicts, laid out as the reference's (`x @ W`, W of
shape (in, out)); functions are pure. Compute follows the input dtype
with float32 statistics where the reference takes them (norms, RoPE,
the loss).

`embed_lookup` indexes the table's rows, which are the rows the
reference's one-hot matmul returns; its backward sums each row's
gradient over the tokens in float32 and rounds once, as the one-hot
matmul's float32 accumulation does, instead of the bfloat16
accumulation of indexing's own backward. `remat` is the reference's
`jax.checkpoint`: `torch.utils.checkpoint` (non-reentrant), which keeps
a function's inputs and runs it again in the backward. Under a
tensor-parallel plan `mlp` and `embed_lookup` take this rank's shares
and sum over "model" (their docstrings).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..distributed.shardctx import all_gather, all_reduce, copy_to, \
    data_axes, local_range


def dense_init(gen: torch.Generator, shape, scale: float | None = None,
               dtype=torch.bfloat16):
    """Normal(0, scale^2) in float32 from `gen`, cast to `dtype`, on
    the generator's device; scale defaults to fan_in^-0.5."""
    if gen.device.type == "meta":                 # shapes only, no draw
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = (1.0 / fan_in) ** 0.5 if scale is None else scale
    x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * scale).to(dtype)


def rms_norm(x, scale, eps: float = 1e-6):
    """RMS norm in float32 with the scale stored as (1 + scale)."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dt)


def layer_norm(x, scale, bias, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    out = out * scale.float() + bias.float()
    return out.to(dt)


def norm_params(d: int, kind: str, dtype, device):
    if kind == "layer":
        return {"scale": torch.ones(d, dtype=dtype, device=device),
                "bias": torch.zeros(d, dtype=dtype, device=device)}
    return {"scale": torch.zeros(d, dtype=dtype, device=device)}


def apply_norm(x, p, kind: str, eps: float = 1e-6):
    if kind == "layer":
        return layer_norm(x, p["scale"], p["bias"], eps)
    return rms_norm(x, p["scale"], eps)


def rope_freqs(hd: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x, positions, theta: float = 10_000.0):
    """x: (..., S, H, hd); positions broadcastable to (..., S). Float32,
    split-half rotation, result in x's dtype."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    ang = positions.float()[..., None] * freqs           # (..., S, hd/2)
    ang = ang[..., None, :]                              # (..., S, 1, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos(seq_len: int, d: int, dtype=torch.bfloat16, device=None):
    """(seq_len, d) table: sin at even columns, cos at odd, computed in
    float32 as the reference computes it, cast to `dtype`."""
    f32 = torch.float32
    pos = torch.arange(seq_len, dtype=f32, device=device)[:, None]
    step = -torch.log(torch.tensor(10_000.0, dtype=f32)) / d
    div = torch.exp(torch.arange(0, d, 2, dtype=f32, device=device)
                    * step.to(device))
    pe = torch.zeros((seq_len, d), dtype=f32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.to(dtype)


def mlp_params(gen, d: int, f: int, glu: bool, dtype):
    p = {"up": dense_init(gen, (d, f), dtype=dtype),
         "down": dense_init(gen, (f, d), dtype=dtype)}
    if glu:
        p["gate"] = dense_init(gen, (d, f), dtype=dtype)
    return p


def apply_act(x, act: str):
    """silu, or gelu in its tanh form (jax.nn.gelu's default)."""
    return F.silu(x) if act == "silu" else F.gelu(x, approximate="tanh")


def mlp(x, p, act: str = "silu", glu: bool = True, d_ff: int = 0):
    """The (gated) MLP. Given the full width `d_ff`, `p` may hold this
    rank's share of it (column-parallel `up` / `gate`, row-parallel
    `down`, `launch.sharding`): the output is then summed over "model"
    (one all-reduce)."""
    down = p["down"]
    split = bool(d_ff) and down.shape[0] != d_ff
    if split:
        x = copy_to(x, "model")
    up = x @ p["up"]
    h = apply_act(x @ p["gate"], act) * up if glu else apply_act(up, act)
    out = h @ down
    return all_reduce(out, "model") if split else out


# -- embedding and the chunked cross-entropy loss -----------------------------

class _Embed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.table = (table.shape, table.dtype)
        return table[tokens]

    @staticmethod
    def backward(ctx, g):
        tokens, = ctx.saved_tensors
        shape, dtype = ctx.table
        acc = torch.zeros(shape, dtype=torch.float32, device=g.device)
        acc.index_put_((tokens.reshape(-1).long(),),
                       g.reshape(-1, shape[1]).float(), accumulate=True)
        return acc.to(dtype), None


def embed_lookup(tokens, table, rows: int = 0, cols: int = 0):
    """table[tokens]: (B, S) integer -> (B, S, D); the table's gradient
    sums in float32 and rounds once to the table's dtype. Given the full
    row count `rows`, `table` may be this rank's vocabulary share (the
    plan's split over "model"): each rank looks up the tokens it holds,
    zeros for the others, and the rows are summed over "model" (one
    all-reduce; reference lines 113-116), exactly the row, as every other
    rank adds zeros; the gradient reaches this rank's own rows. Given the
    full width `cols`, `table` may be this rank's share of the d_model
    columns (the plan's fallback where the rows do not divide): the rank
    looks up its columns and they are all-gathered over "model" (one
    all-gather; every rank reads the whole rows alike, so the gradient
    of its columns is its own slice)."""
    if cols and table.shape[1] != cols:
        x = _Embed.apply(table, tokens)
        return all_gather(x, "model", x.dim() - 1, grad="slice")
    if not rows or table.shape[0] == rows:
        return _Embed.apply(table, tokens)
    lo, hi = local_range(rows, table.shape[0])
    mine = (tokens >= lo) & (tokens < hi)
    x = _Embed.apply(table, (tokens - lo).clamp(0, hi - lo - 1)) \
        * mine[..., None]
    return all_reduce(x, "model")


def remat(on: bool, fn, *args):
    """fn(*args), under `torch.utils.checkpoint` when `on` and autograd
    records (the reference's `jax.checkpoint`)."""
    if on and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def _chunk_ce(h, table, labels, mask, valid_vocab: int, lo: int,
              split: bool):
    """CE over one token chunk; float32 logits from the table-dtype
    product, padded vocabulary rows at -1e30. The table may be this
    rank's vocabulary share, rows [lo, lo + its rows): the log-sum-exp
    then takes the max over "model" (no gradient), sums the exponentials
    over "model", and the rank holding a label gives its logit (two
    all-reduces and a max). Or it may be this rank's share of the d_model
    columns, h then its columns too: the logits are this rank's partial
    products, summed over "model" (one all-reduce). Returns (sum of the
    masked losses, sum of the mask)."""
    if h.shape[1] != table.shape[1]:
        c0, c1 = local_range(h.shape[1], table.shape[1])
        logits = all_reduce((h[:, c0:c1] @ table.T).float(), "model")
    else:
        logits = (h @ table.T).float()                   # (T, Vl)
    Vl = table.shape[0]
    if valid_vocab and lo + Vl > valid_vocab:
        cols = torch.arange(lo, lo + Vl, device=h.device) < valid_vocab
        logits = torch.where(cols[None, :], logits, -1e30)
    if not split:
        lse = torch.logsumexp(logits, -1)
        gold = logits.gather(-1, labels[:, None])[:, 0]
    else:
        m = all_reduce(logits.detach().amax(-1), "model", op="max")
        lse = m + torch.log(all_reduce(
            torch.exp(logits - m[:, None]).sum(-1), "model"))
        own = (labels >= lo) & (labels < lo + Vl)
        gold = all_reduce(torch.where(own, logits.gather(
            -1, (labels - lo).clamp(0, Vl - 1)[:, None])[:, 0], 0.0),
            "model")
    return ((lse - gold) * mask).sum(), mask.sum()


def chunked_ce_loss(h, table, labels, mask=None, chunk: int = 1024,
                    valid_vocab: int = 0, rows: int = 0):
    """Mean cross-entropy of h (B, S, D) against the (V, D) unembedding
    at labels (B, S), over the positions `mask` (B, S) keeps (all by
    default). Chunks are taken along the sequence, cs = max(chunk // B,
    1) positions of every row at a time (one chunk when S % cs or S <=
    cs); each chunk's logits are recomputed in the backward, so the
    (B, S, V) logits are never resident (reference lines 135-183).

    Under a tensor-parallel plan, given the full row count `rows`, the
    table may be this rank's vocabulary share (`_chunk_ce`; h's gradient
    is then summed over "model"), or its share of the d_model columns
    (each rank's partial logits summed over "model", h's gradient
    summed too), and the rows of h this rank's data shard: the
    masked-loss sum and the mask count are summed over the data axes
    the batch is split on (`shardctx.data_axes`), so the loss is the
    global token mean, and the count takes no gradient."""
    B, S, D = h.shape
    labels = labels.long()
    mask_f = (torch.ones((B, S), dtype=torch.float32, device=h.device)
              if mask is None else mask.float())
    lo, split = 0, bool(rows) and table.shape[0] != rows
    if split:
        lo, _ = local_range(rows, table.shape[0])
    if split or table.shape[1] != D:
        h = copy_to(h, "model")

    def one(hc, lc, mc):
        return checkpoint(_chunk_ce, hc.reshape(-1, D), table,
                          lc.reshape(-1), mc.reshape(-1), valid_vocab, lo,
                          split, use_reentrant=False, preserve_rng_state=False)
    cs = max(chunk // B, 1)
    if S % cs != 0 or S <= cs:
        loss, cnt = one(h, labels, mask_f)
    else:
        loss = cnt = 0.0
        for hc, lc, mc in zip(h.split(cs, 1), labels.split(cs, 1),
                              mask_f.split(cs, 1)):
            l, k = one(hc, lc, mc)
            loss, cnt = loss + l, cnt + k
    for a in data_axes():
        loss = all_reduce(loss, a)
        cnt = all_reduce(cnt.detach(), a)
    return loss / cnt.clamp_min(1.0)

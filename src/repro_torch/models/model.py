"""Decoder-only model over a repeating block pattern: init, caches,
the training loss, prefill and decode.

Port of `repro.models.model` (lines 30-215), the vision frontend
included: `forward(frontend_embeds=)` prepends the projected image
embeddings outside decode, `loss_fn` cuts their positions before the
loss, and `prefill` sizes the caches for image plus text tokens
(`_ctx_len`). The reference scans per-slot parameters stacked over
`n_cycles` and then runs `n_rem` remainder layers; here the same
layers, in the same order (`cfg.layer_types`), are one list that a
Python loop walks. In train mode with `cfg.remat`, each cycle of
`cfg.pattern` layers runs under `torch.utils.checkpoint`, as the
reference's scanned body sits under `jax.checkpoint` (line 124); the
remainder layers are not checkpointed. Parameters are a tree {"embed",
"final_norm", ["lm_head",] ["frontend_proj",] "layers": [block, ...]}
(a nested dict or `api.Model`, which holds the same tree as modules);
caches are {"pos": int, "layers": [per-layer dict]}. As in the
reference (line 111), the residual stream passes `constrain(h,
"residual")` at the start of each train or prefill cycle: a no-op
without a mesh and a rule pinned (`distributed.shardctx`), so a
single-device run computes exactly what it did without it.

Under a tensor-parallel plan the embedding table and the unembedding
are this rank's vocabulary share: `embed_lookup` sums the rows over
"model", `masked_logits` returns the share's columns (the padded ones
masked on the rank that holds them) and `greedy_tokens` picks the token
across the shares without gathering the logits. The vision
`frontend_proj` split by columns is gathered over "model". `loss_fn`
runs there too, on this rank's rows: the chunked CE over the vocabulary
share, the loss the global token mean over the data shards
(`layers.chunked_ce_loss`), the gradients flowing back through the
collectives (`distributed.shardctx`).
"""
from __future__ import annotations

import torch

from ..distributed.shardctx import all_gather, constrain, local_range
from .blocks import block_cache_spec, block_forward, block_params, \
    whole_columns
from .config import ModelConfig
from .layers import apply_norm, chunked_ce_loss, dense_init, embed_lookup, \
    norm_params, remat


def _embed(tokens, table, cfg: ModelConfig):
    """Table rows of the tokens times the embedding scale rounded to the
    table's dtype (the reference's one-hot matmul returns the same rows);
    the table may be this rank's vocabulary share (`embed_lookup`)."""
    if table.shape[1] != cfg.d_model:
        raise NotImplementedError("an embedding split over d_model")
    x = embed_lookup(tokens, table, rows=cfg.padded_vocab)
    s = float(torch.tensor(cfg.embed_scale, dtype=table.dtype))
    return x * s


def _unembed_table(params, cfg: ModelConfig):
    return params["embed"] if cfg.tie_embeddings else params["lm_head"]


def masked_logits(h_last, table, cfg: ModelConfig):
    """(B, D) against a (V, D) table -> (B, V) float32 with padded-vocab
    columns at -1e30. The table may be this rank's vocabulary share: the
    logits are then its columns (B, V / model), the padded ones masked on
    the rank that holds them."""
    logits = h_last.float() @ table.float().T
    lo, hi = local_range(cfg.padded_vocab, table.shape[0])
    if hi > cfg.vocab:
        logits[:, max(cfg.vocab - lo, 0):] = -1e30
    return logits


def greedy_tokens(logits, cfg: ModelConfig):
    """Temperature-0 tokens (B,) int32 of whole logits, or of this rank's
    vocabulary share of them: each rank's (max, lowest index at the max)
    is all-gathered over "model" (one all-gather of 2 x B values, never
    the (B, V) logits) and the first rank holding the overall max wins,
    so ties go to the lowest index, as `argmax` breaks them."""
    if logits.shape[-1] == cfg.padded_vocab:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    lo, _ = local_range(cfg.padded_vocab, logits.shape[-1])
    val, idx = logits.max(-1)
    pair = torch.stack([val.double(), (idx + lo).double()], -1)
    pairs = all_gather(pair[None], "model", 0)            # (model, B, 2)
    best = pairs[..., 0].argmax(0)
    return pairs[..., 1].gather(0, best[None])[0].to(torch.int32)


def _logits(h_last, params, cfg: ModelConfig):
    return masked_logits(h_last, _unembed_table(params, cfg), cfg)


def init_params(cfg: ModelConfig, gen: torch.Generator):
    """The parameter tree, drawn from `gen` on its device."""
    params = {
        "embed": dense_init(gen, (cfg.padded_vocab, cfg.d_model),
                            scale=0.02, dtype=cfg.dtype),
        "final_norm": norm_params(cfg.d_model, cfg.norm, cfg.dtype,
                                  gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.padded_vocab, cfg.d_model),
                                       scale=0.02, dtype=cfg.dtype)
    if cfg.frontend != "none":
        params["frontend_proj"] = dense_init(
            gen, (cfg.frontend_dim, cfg.d_model), dtype=cfg.dtype)
    params["layers"] = [block_params(gen, cfg, blk)
                        for blk in cfg.layer_types]
    return params


def init_cache(cfg: ModelConfig, batch: int, ctx: int, device=None):
    return {"pos": 0,
            "layers": [block_cache_spec(cfg, blk, batch, ctx, device)
                       for blk in cfg.layer_types]}


def _train_layers(params, cfg: ModelConfig, x):
    """Every layer in train mode: (hidden, the MoE aux losses summed in
    layer order)."""
    layers, types = params["layers"], cfg.layer_types
    period = len(cfg.pattern)

    def run(h, aux, lo, hi):
        for i in range(lo, hi):
            h, _, a = block_forward(h, layers[i], cfg, types[i], "train",
                                    None, 0)
            aux = aux + a
        return h, aux
    aux = 0.0
    for c in range(cfg.n_cycles):
        x = constrain(x, "residual")
        x, aux = remat(cfg.remat, run, x, aux, c * period, (c + 1) * period)
    return run(x, aux, cfg.n_cycles * period, cfg.n_layers)


def forward(params, cfg: ModelConfig, tokens, *, mode: str, cache=None,
            frontend_embeds=None, pad_to: int = 0):
    """tokens: (B, S) integer; frontend_embeds (B, F, frontend_dim), read
    outside decode. Returns (hidden (B, F + S, D), new cache (None in
    train), the MoE aux loss summed over layers (train; else 0.0))."""
    pos = cache["pos"] if mode == "decode" else 0
    x = _embed(tokens, params["embed"], cfg)
    if cfg.frontend != "none" and mode != "decode" \
            and frontend_embeds is not None:
        fe = frontend_embeds.to(cfg.dtype) @ params["frontend_proj"]
        fe, = whole_columns([(fe, cfg.d_model)], grad="slice")
        x = torch.cat([fe, x], dim=1)
    aux, new_cache = 0.0, None
    if mode == "train":
        x, aux = _train_layers(params, cfg, x)
    else:
        new_layers, period = [], len(cfg.pattern)
        for i, blk in enumerate(cfg.layer_types):
            if (mode == "prefill" and i % period == 0
                    and i < cfg.n_cycles * period):
                x = constrain(x, "residual")
            c = cache["layers"][i] if mode == "decode" else None
            x, nc, _ = block_forward(x, params["layers"][i], cfg, blk, mode,
                                     c, pos, pad_to)
            new_layers.append(nc)
        new_cache = {"pos": pos, "layers": new_layers}
    x = apply_norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    return x, new_cache, aux


def loss_fn(params, cfg: ModelConfig, batch):
    """batch: tokens (B, S), labels (B, S), optional loss_mask and
    frontend_embeds (B, F, frontend_dim). Returns (ce + 0.01 aux,
    {"ce", "aux"}), float32 scalars (reference lines 174-187)."""
    h, _, aux = forward(params, cfg, batch["tokens"], mode="train",
                        frontend_embeds=batch.get("frontend_embeds"))
    if cfg.frontend != "none" and "frontend_embeds" in batch:
        h = h[:, batch["frontend_embeds"].shape[1]:]
    ce = chunked_ce_loss(h, _unembed_table(params, cfg), batch["labels"],
                         batch.get("loss_mask"), cfg.loss_chunk,
                         valid_vocab=cfg.vocab, rows=cfg.padded_vocab)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=ce.device)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def prefill(params, cfg: ModelConfig, tokens, frontend_embeds=None,
            pad_to: int = 0):
    """pad_to: the context the caches are sized for (>= the prompt, image
    tokens included). Returns (logits (B, V) float32 at the last prompt
    token, cache)."""
    ctx = _ctx_len(cfg, tokens, frontend_embeds)
    h, cache, _ = forward(params, cfg, tokens, mode="prefill",
                          frontend_embeds=frontend_embeds,
                          pad_to=max(pad_to, ctx))
    cache["pos"] = ctx
    return _logits(h[:, -1], params, cfg), cache


def _ctx_len(cfg: ModelConfig, tokens, frontend_embeds) -> int:
    n = tokens.shape[1]
    if cfg.frontend != "none" and frontend_embeds is not None:
        n += frontend_embeds.shape[1]
    return n


def decode_step(params, cfg: ModelConfig, cache, tokens):
    """tokens: (B, 1). Returns (logits (B, V) float32, new cache); the
    attention caches are written in place (see `blocks`)."""
    h, new_cache, _ = forward(params, cfg, tokens, mode="decode",
                              cache=cache)
    new_cache["pos"] = cache["pos"] + 1
    return _logits(h[:, 0], params, cfg), new_cache

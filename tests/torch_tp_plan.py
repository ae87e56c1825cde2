"""The collectives a tensor-parallel forward makes under its plan, counted
from the config and the mesh (not a test module; the tensor-parallel
tests hold the executed and the dry-run counts against it)."""


def _div(n, m):
    return n % m == 0 and n >= m


def fsdp_leaves(cfg, sizes, fsdp):
    """How many parameter leaves the plan FSDP-shards over "data": each
    is gathered once where a forward reads it."""
    if not fsdp:
        return 0
    from repro_torch.launch import sharding as shr
    from repro_torch.models import Model
    model = Model(cfg.replace(vocab_pad_to=256), device="meta")
    plan = shr.param_pspecs(model, sizes, fsdp=True)
    return sum(any("data" in axes for axes in
                   shr._layer_spec(model.cfg, name, plan))
               for name, _ in model.named_parameters())


def want_collectives(cfg, sizes, decode, fsdp=0, ctx=32768):
    """{kind: count} of one forward on a mesh of `sizes`: over "model"
    one all-reduce each for the embedding (vocabulary split), `wo`, the
    dense MLP's `down`, the MoE's `out` and the SSD's gated norm and
    `out_proj`, one all-gather for the greedy token, the head-cut
    attention's projections and, at decode, its merge over the cache's
    slots, the vision embeddings at prefill and the SSD's conv_B /
    conv_C channels at decode; over each batch axis the MoE's aux; one
    all-gather per FSDP leaf."""
    m = sizes.get("model", 1)
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    types = cfg.layer_types
    n_moe = sum(b.mlp == "moe" for b in types)
    ar, ag = 0, fsdp
    if m > 1:
        if _div(cfg.replace(vocab_pad_to=256).padded_vocab, m):
            ar += 1                                   # the embedding
            ag += 1                                   # the greedy token
        Hc = H * hd // m if _div(H * hd, m) else H * hd
        Kc = K * hd // m if _div(K * hd, m) else K * hd
        whole = Hc % hd == 0 and Kc % hd == 0 and Hc * K == Kc * H
        for b in types:
            if b.mixer == "attn":
                ar += Hc != H * hd
                if not whole:
                    ag += 1
                    C = b.cache_len(ctx)
                    ag += decode and not _div(K, m) and _div(C, m)
            if b.mixer == "ssd":
                split = _div(cfg.ssm_heads, m)
                ar += 2 * split
                ag += decode and _div(cfg.ssm_groups * cfg.ssm_state, m)
            if b.mlp == "dense":
                ar += _div(cfg.d_ff, m)
            if b.mlp == "moe":
                ar += 1
        if cfg.frontend == "vision" and not decode:
            ag += _div(cfg.d_model, m)
    ar += n_moe * sum(sizes.get(a, 1) > 1 for a in ("pod", "data"))
    return {"all_reduce": int(ar), "all_gather": int(ag),
            "reduce_scatter": 0}

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


def _attn_cut(cfg, m):
    """(wo split, heads cut) of an attention on m "model" ranks."""
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    Hc = H * hd // m if _div(H * hd, m) else H * hd
    Kc = K * hd // m if _div(K * hd, m) else K * hd
    whole = Hc % hd == 0 and Kc % hd == 0 and Hc * K == Kc * H
    return Hc != H * hd, not whole


def want_encdec(cfg, sizes, decode, ctx):
    """`want_collectives` of the encoder-decoder: over "model" one
    all-reduce for the embedding, each attention's `wo` and each MLP's
    `down`; one all-gather for the greedy token, the encoder's
    `frontend_proj` (prefill) and, where the heads are cut, each
    attention's projections (prefill: self q/k/v, cross q and cross k/v,
    and the cross caches' k/v once more; decode: self q/k/v, cross q)
    and at decode each attention's merge over its share of the slots."""
    m = sizes.get("model", 1)
    if m == 1:
        return {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0}
    split, cut = _attn_cut(cfg, m)
    mlp = _div(cfg.d_ff, m)
    ar = ag = 0
    if _div(cfg.replace(vocab_pad_to=256).padded_vocab, m):
        ar, ag = 1, 1
    if decode:
        ar += cfg.n_layers * (2 * split + mlp)
        if cut:
            K = cfg.n_kv_heads
            ag += cfg.n_layers * (2 + (not _div(K, m) and _div(
                cfg.dec_max_len, m)) + (not _div(K, m) and _div(ctx, m)))
    else:
        ag += _div(cfg.d_model, m)
        ar += cfg.n_enc_layers * (split + mlp) + cfg.n_layers * (
            2 * split + mlp)
        if cut:
            ag += cfg.n_enc_layers + 4 * cfg.n_layers
    return {"all_reduce": int(ar), "all_gather": int(ag),
            "reduce_scatter": 0}


def want_collectives(cfg, sizes, decode, fsdp=0, ctx=32768):
    """{kind: count} of one forward on a mesh of `sizes`: over "model"
    one all-reduce each for the embedding (vocabulary split), `wo`, the
    dense MLP's `down`, the MoE's `out` and the SSD's gated norm and
    `out_proj`, one all-gather for the greedy token, the head-cut
    attention's projections and, at decode, its merge over the cache's
    slots, the vision embeddings at prefill and the SSD's conv_B /
    conv_C channels at decode; the RG-LRU's `w_out` (an all-reduce) and
    its `u` for the gates (an all-gather); over each batch axis the
    MoE's aux; one all-gather per FSDP leaf. The encoder-decoder's:
    `want_encdec`."""
    if cfg.is_encdec:
        return want_encdec(cfg, sizes, decode, ctx)
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
            if b.mixer == "rglru" and _div(cfg.lru_width or cfg.d_model, m):
                ar += 1                               # w_out
                ag += 1                               # u, for the gates
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


def _ce_chunks(rows, S, chunk):
    cs = max(chunk // rows, 1)
    return 1 if (S % cs or S <= cs) else S // cs


def want_value_and_grad(cfg, sizes, rows, S_text, fsdp=0):
    """{kind: count} of one `value_and_grad` of `rows` rows on a mesh of
    `sizes` under a train cell's plan, forward and backward:

      * f (`copy_to`: an all-reduce in the backward) in front of each
        split projection's input, the SSD's B / C and per-head
        parameters, the q/k norms of split heads, the stacked RG-LRU's
        whole conv, the MoE experts' input and combine weights, the CE's
        hidden states;
      * g (an all-reduce in the forward) after each row-split product,
        the embedding, the SSD's gated-norm sum (an f follows it), the
        CE's exp-sum and gold logit (with its max), the loss and its
        count over each data axis, the MoE's aux over each data axis;
      * each all-gather whose ranks read differently (the RG-LRU's u,
        the cut heads' projections, FSDP leaves) reduce-scatters back;
        the vision / audio frontend's gather is sliced back (no
        collective);
      * under remat each cycle's (whisper: each layer's) forward
        collectives run again in the backward, but for the all-reduces
        that end it (its last MLP's, or the SSD's output where there is
        none): `torch.utils.checkpoint` stops recomputing
        at the last tensor the backward saved; the CE's chunks are
        always recomputed whole."""
    m = sizes.get("model", 1)
    dp = sum(sizes.get(a, 1) > 1 for a in ("pod", "data"))
    ar = ag = rs = 0
    vocab = m > 1 and _div(cfg.replace(vocab_pad_to=256).padded_vocab, m)
    if vocab:
        nch = _ce_chunks(rows, S_text, cfg.loss_chunk)
        ar += 1 + 6 * nch + 1            # embed; CE fwd + recompute; f(h)
    ar += 2 * dp                         # the loss and its count
    ag += fsdp
    rs += fsdp
    split, cut = _attn_cut(cfg, m)

    def attn(self_attn=True):
        """(fwd ar, fwd ag, bwd ar, bwd rs) of one attention."""
        n_in = 1 if self_attn else 2
        return (int(split), (1 if self_attn else 2) * cut,
                n_in * split + (cfg.qk_norm and split),
                (1 if self_attn else 2) * (cut and split))
    if cfg.is_encdec:
        if m > 1:
            ag += _div(cfg.d_model, m)
            mlp = _div(cfg.d_ff, m)
            enc = [a + b for a, b in zip(attn(), (mlp, 0, mlp, 0))]
            x = attn(False)
            dec = [a + b + c for a, b, c in zip(attn(), x, (mlp, 0, mlp, 0))]
            for n, (far, fag, bar, brs) in ((cfg.n_enc_layers, enc),
                                            (cfg.n_layers, dec)):
                again = far - mlp if cfg.remat else 0
                ar += n * (far + again + bar)
                ag += n * fag * (2 if cfg.remat else 1)
                rs += n * brs
        return {"all_reduce": int(ar), "all_gather": int(ag),
                "reduce_scatter": int(rs)}
    if m > 1 and cfg.frontend == "vision":
        ag += _div(cfg.d_model, m)
    period = len(cfg.pattern)
    for i, b in enumerate(cfg.layer_types):
        far = fag = bar = brs = 0
        if m > 1 and b.mixer == "attn":
            far, fag, bar, brs = attn()
        if m > 1 and b.mixer == "ssd" and _div(cfg.ssm_heads, m):
            far, bar = 2, 5
        if m > 1 and b.mixer == "rglru" and _div(cfg.lru_width
                                                 or cfg.d_model, m):
            stacked = i < cfg.n_cycles * period
            far, fag, bar, brs = 1, 1, 1 + stacked, 1
        if m > 1 and b.mlp == "dense" and _div(cfg.d_ff, m):
            far, bar = far + 1, bar + 1
        if b.mlp == "moe":
            far += dp + (m > 1)
            bar += 2 * (m > 1)
        again = cfg.remat and i < cfg.n_cycles * period
        # the recomputation stops at the cycle's last saved tensor: the
        # all-reduces that end its last layer do not run again
        trail = 0
        if again and i % period == period - 1:
            if b.mlp == "dense":
                trail = int(m > 1 and _div(cfg.d_ff, m))
            elif b.mlp == "moe":
                trail = dp + (m > 1)
            else:
                trail = int(m > 1 and b.mixer == "ssd"
                            and _div(cfg.ssm_heads, m))
        ar += far + (far - trail if again else 0) + bar
        ag += fag * (2 if again else 1)
        rs += brs
    return {"all_reduce": int(ar), "all_gather": int(ag),
            "reduce_scatter": int(rs)}


def want_train_step(cfg, sizes, plan, rows, S_text, fsdp=0,
                    microbatches=1, compression=False):
    """{kind: count} of one train step under `plan` (`lower_cell`'s): k
    microbatches' `want_value_and_grad`, then per stacked leaf the data
    ranks' sum over each data axis it is not FSDP-split on (a
    reduce-scatter where the ZeRO moments split on that axis, else an
    all-reduce) and the updated parameter's all-gather over the axes
    ZeRO adds; the global norm's piece sum (one all-reduce per mesh axis
    some leaf is split on) and, with compression, the scales' MAX and
    the error's piece sum (as many again each)."""
    from repro_torch.launch import sharding as shr
    from repro_torch.models import Model
    k = microbatches
    vg = want_value_and_grad(cfg, sizes, rows // k, S_text, fsdp)
    out = {key: v * k for key, v in vg.items()}
    names = Model(cfg.replace(vocab_pad_to=256), device="meta").param_specs()
    axes_used = set()
    dp_axes = [a for a in ("pod", "data") if sizes.get(a, 1) > 1]
    for path in shr.stacked_groups(cfg, names):
        pspec, ospec = plan["params"][path].spec, plan["opt"]["m"][path].spec
        for a in dp_axes:
            if any(a in axes for axes in pspec):
                continue
            if any(a in axes for axes in ospec):
                out["reduce_scatter"] += 1
            else:
                out["all_reduce"] += 1
        for p, o in zip(pspec, ospec):
            out["all_gather"] += sum(sizes[a] > 1 for a in o if a not in p)
        axes_used |= {a for axes in ospec for a in axes if sizes[a] > 1}
    out["all_reduce"] += len(axes_used) * (3 if compression else 1)
    return out

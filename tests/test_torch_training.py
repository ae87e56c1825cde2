"""The port's training path against the reference's, on the CPU: the
chunked cross-entropy loss, `Model.loss` and every parameter gradient,
AdamW, the int8 gradient codec and the token stream (the train step,
the loop and the launcher: `tests/test_torch_train_launch.py`).

Weights, gradients and optimizer states cross by
`repro_torch.models.bridge` (`params_from_jax`, `opt_state_from_jax`);
inputs come from seeded numpy generators. Float32 throughout.
Tolerances, each relative to the tensor's largest magnitude:

  * loss, ce and aux: 1e-6; every gradient leaf: 1e-5 (the two packages
    sum their products in other orders; measured up to 3.4e-6);
  * one AdamW update (params, m, v, lr, grad_norm): 1e-5. The reference
    stacks each pattern slot's layers into one leaf, so its global norm
    adds the leaves in another order (a difference by construction);
  * `compress_decompress` and `TokenStream`: bitwise; the codec's scale
    is taken over each of the reference's stacked leaves.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.distributed import compression
from repro_torch.models import Model
from repro_torch.models.bridge import opt_state_from_jax, params_from_jax
from repro_torch.models.layers import chunked_ce_loss, embed_lookup
from repro_torch.training import data, optimizer as opt

FAMILIES = ["granite-3-2b", "mamba2-1.3b", "recurrentgemma-2b",
            "granite-moe-3b-a800m", "phi-3-vision-4.2b", "whisper-tiny"]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = float(np.abs(b).max()) or 1.0
    return float(np.abs(a - b).max()) / scale


def _np(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    """pair(arch, **replace) -> (reference model, its params, port model
    on the same weights), float32, built once per key."""
    built = {}

    def get(name, **kw):
        key = (name, tuple(sorted(kw.items())))
        if key not in built:
            import jax
            import jax.numpy as jnp
            from repro.configs import get_config as ref_get
            from repro.configs import smoke_variant as ref_smoke
            from repro.models import Model as RefModel
            rcfg = ref_smoke(ref_get(name)).replace(dtype=jnp.float32, **kw)
            pcfg = smoke_variant(get_config(name)).replace(
                dtype=torch.float32, **kw)
            ref = RefModel(rcfg)
            params = ref.init(jax.random.key(0))
            port = Model(pcfg, device="cpu")
            port.load_state_dict(params_from_jax(_np(params), pcfg))
            built[key] = (ref, params, port)
        return built[key]
    return get


_JITTED = {}


def _ref_value_and_grad(ref, params, batch):
    """The reference's jitted value_and_grad, compiled once per model."""
    import jax
    import jax.numpy as jnp
    if id(ref) not in _JITTED:
        _JITTED[id(ref)] = (ref, jax.jit(jax.value_and_grad(ref.loss,
                                                            has_aux=True)))
    return _JITTED[id(ref)][1](params, {k: jnp.asarray(v)
                                        for k, v in batch.items()})


# -- chunked cross-entropy ----------------------------------------------------

@pytest.mark.parametrize("chunk,S,masked", [(64, 16, False), (8, 16, False),
                                            (8, 16, True), (8, 12, False)])
def test_chunked_ce_loss_value_and_grad(chunk, S, masked):
    """One chunk (S <= chunk // B), four chunks of 4 positions, the same
    with a loss mask, and a length the chunk does not divide (one
    chunk). The table has 40 rows of which 37 are vocabulary."""
    import jax
    import jax.numpy as jnp
    from repro.models import layers as ref
    rng = np.random.default_rng(1)
    B, D, V, valid = 2, 8, 40, 37
    h = rng.standard_normal((B, S, D), dtype=np.float32)
    table = rng.standard_normal((V, D), dtype=np.float32)
    labels = rng.integers(0, valid, (B, S)).astype(np.int32)
    mask = (rng.uniform(size=(B, S)) < 0.7) if masked else None

    def rf(h, t):
        return ref.chunked_ce_loss(h, t, jnp.asarray(labels),
                                   None if mask is None else
                                   jnp.asarray(mask), chunk, valid)
    rl, (rgh, rgt) = jax.value_and_grad(rf, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(table))
    th, tt = (torch.from_numpy(x).requires_grad_() for x in (h, table))
    pl = chunked_ce_loss(th, tt, torch.from_numpy(labels),
                         None if mask is None else torch.from_numpy(mask),
                         chunk, valid)
    pl.backward()
    assert _rel(pl.item(), float(rl)) <= 1e-6
    assert _rel(th.grad, rgh) <= 1e-5
    assert _rel(tt.grad, rgt) <= 1e-5


def test_embedding_gradient_sums_in_float32():
    """bfloat16 table: each row's gradient is the float32 sum over its
    tokens, rounded once (the reference's one-hot matmul)."""
    rng = np.random.default_rng(2)
    table = torch.zeros((6, 4), dtype=torch.bfloat16, requires_grad=True)
    tokens = torch.from_numpy(rng.integers(0, 6, (3, 40)))
    g = rng.standard_normal((3, 40, 4), dtype=np.float32)
    embed_lookup(tokens, table).backward(
        torch.from_numpy(g).to(torch.bfloat16))
    want = np.zeros((6, 4), np.float32)
    np.add.at(want, tokens.numpy().reshape(-1),
              torch.from_numpy(g).to(torch.bfloat16).float().numpy()
              .reshape(-1, 4))
    assert torch.equal(table.grad,
                       torch.from_numpy(want).to(torch.bfloat16))


# -- the loss and every gradient ----------------------------------------------

@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_every_gradient_match_reference(pair, name):
    from repro.training.data import batch_for
    ref, params, port = pair(name)
    batch = batch_for(ref.cfg, 24, 2, seed=3)
    (rl, rm), rg = _ref_value_and_grad(ref, params, batch)
    (pl, pm), pg = port.value_and_grad(batch)
    assert _rel(pl, float(rl)) <= 1e-6
    for k in ("ce", "aux"):
        assert abs(float(pm[k]) - float(rm[k])) <= 1e-6 * max(
            abs(float(rm[k])), 1.0), k
    want = params_from_jax(_np(rg), port.cfg)
    assert sorted(pg) == sorted(want)
    for k, g in pg.items():
        assert g.dtype == want[k].dtype
        assert _rel(g, want[k]) <= 1e-5, k
    assert all(not p.requires_grad for p in port.parameters())


@pytest.mark.parametrize("name", ["recurrentgemma-2b", "whisper-tiny",
                                  "granite-moe-3b-a800m"])
def test_remat_gives_the_same_gradients(pair, name):
    """Remat runs each cycle (whisper: each encoder and decoder layer)
    again in the backward; the gradients are bitwise those without."""
    from repro.training.data import batch_for
    _, _, off = pair(name)
    on = Model(off.cfg.replace(remat=True), device="cpu")
    on.load_state_dict(off.state_dict())
    batch = batch_for(off.cfg, 24, 2, seed=4)
    (l0, _), g0 = off.value_and_grad(batch)
    (l1, _), g1 = on.value_and_grad(batch)
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


# -- AdamW and the decay mask -------------------------------------------------

@pytest.mark.parametrize("step,clip", [(0, 1.0), (37, 0.05), (500, 0.0)])
def test_adamw_update_matches_reference(pair, step, clip):
    """Warm-up, the cosine arm with clipping active, and past the end
    with clipping off; moments carried over from a random state."""
    import jax
    import jax.numpy as jnp
    from repro.training import optimizer as ref_opt
    from repro.training.data import batch_for
    ref, params, port = pair("granite-moe-3b-a800m")
    batch = batch_for(ref.cfg, 24, 2, seed=3)
    _, rg = _ref_value_and_grad(ref, params, batch)
    rng = np.random.default_rng(step)
    shapes = jax.tree.map(np.shape, params)
    rstate = {
        "m": jax.tree.map(lambda s: jnp.asarray(0.01 * rng.standard_normal(
            s, dtype=np.float32)), shapes, is_leaf=lambda x: isinstance(
                x, tuple)),
        "v": jax.tree.map(lambda s: jnp.asarray(1e-4 * rng.uniform(size=s)
                                                .astype(np.float32)),
                          shapes, is_leaf=lambda x: isinstance(x, tuple)),
        "step": jnp.int32(step)}
    pstate = opt_state_from_jax(_np(rstate), port.cfg)
    ocfg = dict(lr=1e-3, warmup_steps=20, total_steps=400, clip_norm=clip)
    rp, rs, rmets = ref_opt.update(ref_opt.AdamWConfig(**ocfg), rg, rstate,
                                   params)
    new = {k: p.detach().clone() for k, p in port.named_parameters()}
    grads = params_from_jax(_np(rg), port.cfg)
    ps, pmets = opt.update(opt.AdamWConfig(**ocfg), grads, pstate, new)
    assert int(ps["step"]) == step + 1 and ps["step"].dtype == torch.int32
    assert _rel(pmets["lr"], float(rmets["lr"])) <= 1e-6
    assert _rel(pmets["grad_norm"], float(rmets["grad_norm"])) <= 1e-5
    for tree, got in ((rp, new), (rs["m"], ps["m"]), (rs["v"], ps["v"])):
        want = params_from_jax(_np(tree), port.cfg)
        for k in want:
            assert _rel(got[k], want[k]) <= 1e-5, k


def test_decay_mask_matches_reference_leaf_for_leaf(pair):
    import jax
    from repro.training import optimizer as ref_opt
    for name in FAMILIES:
        _, params, port = pair(name)
        masks = jax.tree_util.tree_map_with_path(
            lambda path, x: np.full(np.shape(x), ref_opt._decay_mask(path)),
            params)
        bridged = params_from_jax(masks, port.cfg)
        for k, _ in port.named_parameters():
            assert bool(bridged[k].all()) == opt.decay_mask(k), (name, k)
            assert bool(bridged[k].any()) == opt.decay_mask(k), (name, k)


# -- the gradient codec -------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_decompress_bitwise(dtype):
    """Two rounds (the second carrying the first's error) give the
    reference's dequantised gradients and error state bit for bit."""
    import jax.numpy as jnp
    from repro.distributed import compression as ref
    rng = np.random.default_rng(6)
    shapes = {"a": (64, 64), "b": (7,), "c": (3, 5, 2)}
    g = {k: rng.standard_normal(s, dtype=np.float32) * 10.0 ** i
         for i, (k, s) in enumerate(shapes.items())}
    g["b"][:] = 0.0                              # the scale's 1e-12 floor
    rg = {k: jnp.asarray(v, getattr(jnp, dtype)) for k, v in g.items()}
    pg = {k: torch.from_numpy(v).to(getattr(torch, dtype))
          for k, v in g.items()}
    r1, re1, rm1 = ref.compress_decompress(rg)
    p1, pe1, pm1 = compression.compress_decompress(pg)
    r2, re2, _ = ref.compress_decompress(rg, re1)
    p2, pe2, _ = compression.compress_decompress(pg, pe1)
    for rh, ph in ((r1, p1), (re1, pe1), (r2, p2), (re2, pe2)):
        for k in shapes:
            np.testing.assert_array_equal(
                ph[k].float().numpy(), np.asarray(rh[k].astype(jnp.float32)))
    assert pe1["a"].dtype == torch.float32 and p1["a"].dtype == pg["a"].dtype
    assert _rel(pm1["compression_err_sq"],
                float(rm1["compression_err_sq"])) <= 1e-6


@pytest.mark.parametrize("name", FAMILIES)
def test_compress_decompress_stacked_leaves_bitwise(pair, name):
    """On a tree shaped like the parameters, the codec with
    `Model.stacked_leaves` as its groups gives the reference's codec on
    its stacked tree (one scale per `slot{s}`, `enc`, `dec` leaf) bit for
    bit, over two rounds."""
    import jax
    import jax.numpy as jnp
    from repro.distributed import compression as ref
    _, params, port = pair(name)
    rng = np.random.default_rng(7)
    leaves, treedef = jax.tree.flatten(_np(params))
    g = jax.tree.unflatten(treedef, [
        rng.standard_normal(np.shape(x), dtype=np.float32) * 10.0 ** (i % 3)
        for i, x in enumerate(leaves)])
    rg = jax.tree.map(jnp.asarray, g)
    pg = params_from_jax(g, port.cfg)
    groups = port.stacked_leaves()
    r1, re1, rm1 = ref.compress_decompress(rg)
    p1, pe1, pm1 = compression.compress_decompress(pg, groups=groups)
    r2, re2, _ = ref.compress_decompress(rg, re1)
    p2, pe2, _ = compression.compress_decompress(pg, pe1, groups=groups)
    for rh, ph in ((r1, p1), (re1, pe1), (r2, p2), (re2, pe2)):
        want = params_from_jax(_np(rh), port.cfg)
        assert list(ph) == list(pg)
        for k, w in want.items():
            np.testing.assert_array_equal(ph[k].numpy(), w.numpy(), k)
    assert _rel(pm1["compression_err_sq"],
                float(rm1["compression_err_sq"])) <= 1e-6


# -- the token stream ---------------------------------------------------------

def test_token_stream_is_the_references_byte_for_byte():
    from repro.training import data as ref
    a = ref.TokenStream(49155, 33, 5, seed=11).batches(3)
    b = data.TokenStream(49155, 33, 5, seed=11).batches(3)
    for x, y in zip(a, b):
        for k in ("tokens", "labels"):
            assert x[k].dtype == y[k].dtype
            assert x[k].tobytes() == y[k].tobytes()


@pytest.mark.parametrize("name", ["phi-3-vision-4.2b", "whisper-tiny",
                                  "granite-3-2b"])
def test_batch_for_is_the_references(name):
    from repro.configs import get_config as ref_get
    from repro.configs import smoke_variant as ref_smoke
    from repro.training import data as ref
    want = ref.batch_for(ref_smoke(ref_get(name)), 20, 3, seed=2)
    got = data.batch_for(smoke_variant(get_config(name)), 20, 3, seed=2)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes()

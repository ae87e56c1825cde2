"""The port's serving path for the rest of the model zoo (the RG-LRU
hybrid, the two MoE models, the vision-language model and the
encoder-decoder) against the reference `repro.models`.

Weights are the reference's, drawn by `repro.models.Model.init` and
carried over with `repro_torch.models.bridge.params_from_jax`; prompts,
image embeddings and audio frames come from a seeded numpy generator.
Both packages run on the CPU; the port's attention decode goes through
K3's plain version.

  * float32: prefill, then 8 greedy decode steps on the smoke variants
    of recurrentgemma-2b (an odd 27-token prompt past its 16-slot
    window, so the ring wraps and the scan takes its odd branches),
    granite-moe-3b-a800m, mixtral-8x7b, phi-3-vision-4.2b (4 image
    embeddings before 20 tokens) and whisper-tiny (32 frames, a
    10-token decoder prefix, so the 16-slot self-attention ring wraps).
    Greedy tokens identical at every step; logits within rtol = atol =
    1e-4, as `test_torch_models.py` holds the dense and SSM families.
  * bfloat16: the same runs, both fed the reference's greedy tokens;
    logits within atol 5e-2.
  * one decode step from the reference's prefill cache, carried over
    with `bridge.cache_from_jax`, at the float32 tolerance.
  * the pieces alone, float32: `moe_layer` where pairs are dropped (the
    kept pairs those the reference keeps) and with `no_drop` (`out`
    within 1e-5 of its scale, `aux` within 1e-6); `rglru_forward`'s
    prefill and decode (`h` within rtol 1e-5); the encoder; the
    sinusoidal table.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke_variant
from repro_torch.kernels import decode_attention as K3
from repro_torch.models import Model, greedy_sample
from repro_torch.models import blocks, encdec, layers, moe
from repro_torch.models.bridge import cache_from_jax, params_from_jax

STEPS = 8
# (arch, prompt tokens, image embeddings or audio frames)
FAMILIES = [("recurrentgemma-2b", 27, 0), ("granite-moe-3b-a800m", 24, 0),
            ("mixtral-8x7b", 24, 0), ("phi-3-vision-4.2b", 20, 4),
            ("whisper-tiny", 10, 32)]


def _configs(name, dtype):
    import jax.numpy as jnp
    from repro.configs import get_config as ref_get
    from repro.configs import smoke_variant as ref_smoke
    rcfg = ref_smoke(ref_get(name)).replace(dtype=getattr(jnp, dtype))
    pcfg = smoke_variant(get_config(name)).replace(
        dtype=getattr(torch, dtype))
    return rcfg, pcfg


@pytest.fixture(scope="module")
def pair():
    """pair(arch, dtype) -> (reference model, its params, port model) on
    the same weights, built once per (arch, dtype) in this module."""
    built = {}

    def get(name, dtype):
        if (name, dtype) not in built:
            import jax
            from repro.models import Model as RefModel
            rcfg, pcfg = _configs(name, dtype)
            ref = RefModel(rcfg)
            params = ref.init(jax.random.key(0))
            port = Model(pcfg, device="cpu")
            port.load_state_dict(params_from_jax(
                jax.tree.map(np.asarray, params), pcfg))
            built[name, dtype] = (ref, params, port)
        return built[name, dtype]
    return get


def _batch(cfg, S, extra, seed):
    """Tokens (2, S), plus `frames` (2, extra, frontend_dim) for the
    encoder-decoder or `frontend_embeds` (2, extra, frontend_dim) for the
    vision model, as numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, S)).astype(np.int32)}
    if extra:
        key = "frames" if cfg.is_encdec else "frontend_embeds"
        batch[key] = rng.normal(size=(2, extra, cfg.frontend_dim)).astype(
            np.float32)
    return batch


def _ref_steps(ref, params, batch, pad_to):
    import jax
    import jax.numpy as jnp
    prefill = jax.jit(lambda p, b: ref.prefill(p, b, pad_to=pad_to))
    out = prefill(params, {k: jnp.asarray(v) for k, v in batch.items()})
    return out, jax.jit(ref.decode)


def _port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _attn_calls_per_step(cfg):
    if cfg.is_encdec:
        return 2 * cfg.n_layers
    return sum(b.mixer == "attn" for b in cfg.layer_types)


@pytest.mark.parametrize("name,S,extra", FAMILIES)
def test_prefill_and_greedy_decode_match_reference_f32(pair, name, S,
                                                       extra):
    import jax.numpy as jnp
    ref, params, port = pair(name, "float32")
    batch = _batch(port.cfg, S, extra, seed=0)
    pad_to = S + extra + STEPS
    (rl, rc), rdec = _ref_steps(ref, params, batch, pad_to)
    calls = K3.decode_attention.plain_calls
    pl, pc = port.prefill(_port_batch(batch), pad_to=pad_to)
    for step in range(STEPS + 1):
        np.testing.assert_allclose(pl.numpy(), np.asarray(rl), rtol=1e-4,
                                   atol=1e-4, err_msg=f"step {step}")
        if step == STEPS:
            break
        rt = jnp.argmax(rl, -1).astype(jnp.int32)[:, None]
        pt = greedy_sample(pl)[:, None]
        np.testing.assert_array_equal(pt.numpy(), np.asarray(rt))
        rl, rc = rdec(params, rc, rt)
        pl, pc = port.decode(pc, pt)
    assert pc["pos"] == int(rc["pos"])
    assert K3.decode_attention.plain_calls - calls == \
        _attn_calls_per_step(port.cfg) * STEPS


@pytest.mark.parametrize("name,S,extra", FAMILIES)
def test_prefill_and_decode_match_reference_bf16(pair, name, S, extra):
    import jax.numpy as jnp
    ref, params, port = pair(name, "bfloat16")
    batch = _batch(port.cfg, S, extra, seed=1)
    pad_to = S + extra + STEPS
    (rl, rc), rdec = _ref_steps(ref, params, batch, pad_to)
    pl, pc = port.prefill(_port_batch(batch), pad_to=pad_to)
    for step in range(STEPS + 1):
        assert pl.dtype == torch.float32
        np.testing.assert_allclose(pl.numpy(), np.asarray(rl), rtol=0,
                                   atol=5e-2, err_msg=f"step {step}")
        if step == STEPS:
            break
        rt = jnp.argmax(rl, -1).astype(jnp.int32)[:, None]
        rl, rc = rdec(params, rc, rt)
        pl, pc = port.decode(pc, torch.from_numpy(np.array(rt)))


@pytest.mark.parametrize("name,S,extra", FAMILIES)
def test_one_decode_step_from_reference_cache(pair, name, S, extra):
    """The reference's prefill cache, carried over, gives the reference's
    next logits after one port decode step: the RG-LRU state and conv
    window, the wrapped attention ring, the encoder-decoder's stacked
    self and cross caches with their shared positions."""
    import jax
    import jax.numpy as jnp
    ref, params, port = pair(name, "float32")
    batch = _batch(port.cfg, S, extra, seed=2)
    (rl, rc), rdec = _ref_steps(ref, params, batch, S + extra + 4)
    rt = jnp.argmax(rl, -1).astype(jnp.int32)[:, None]
    want, _ = rdec(params, rc, rt)
    cache = cache_from_jax(jax.tree.map(np.asarray, rc), port.cfg,
                           device="cpu")
    assert cache["pos"] == int(rc["pos"])
    got, _ = port.decode(cache, torch.from_numpy(np.array(rt)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_encoder_matches_reference(pair):
    import jax.numpy as jnp
    from repro.models import encdec as ref_encdec
    ref, params, port = pair("whisper-tiny", "float32")
    frames = _batch(port.cfg, 1, 32, seed=3)["frames"]
    want = ref_encdec.encode(params, ref.cfg, jnp.asarray(frames))
    got = encdec.encode(port, port.cfg, torch.from_numpy(frames))
    assert got.shape == (2, 32, port.cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_bridge_unstacks_the_encoder_decoder(pair):
    """`enc` / `dec` layer i is the reference's stacked leaf [i]."""
    import jax
    ref, params, port = pair("whisper-tiny", "float32")
    state = params_from_jax(jax.tree.map(np.asarray, params), port.cfg)
    assert torch.equal(state["dec.1.xattn.wk"],
                       torch.from_numpy(np.array(
                           params["dec"]["xattn"]["wk"])[1]))
    assert torch.equal(state["enc.0.mlp.up"],
                       torch.from_numpy(np.array(
                           params["enc"]["mlp"]["up"])[0]))
    assert set(k.split(".")[0] for k in state) == {
        "frontend_proj", "embed", "pos_dec", "enc", "dec", "enc_norm",
        "dec_norm"}


def _moe_inputs(glu, seed=4):
    rng = np.random.default_rng(seed)
    D, F, E = 32, 48, 8
    p = {"router": rng.normal(size=(D, E)) * 0.5,
         "up": rng.normal(size=(E, D, F)) / np.sqrt(D),
         "down": rng.normal(size=(E, F, D)) / np.sqrt(F)}
    if glu:
        p["gate"] = rng.normal(size=(E, D, F)) / np.sqrt(D)
    x = rng.normal(size=(4, 16, D))
    return x.astype(np.float32), {k: v.astype(np.float32)
                                  for k, v in p.items()}


def _reference_kept(x, p, k, C):
    """The reference's kept (token, choice) pairs, from its own top-k:
    rank among the pairs that chose the same expert < C."""
    import jax
    import jax.numpy as jnp
    probs = jax.nn.softmax(jnp.asarray(x.reshape(-1, x.shape[-1]))
                           @ jnp.asarray(p["router"]), axis=-1)
    flat = np.asarray(jax.lax.top_k(probs, k)[1]).reshape(-1)
    rank = np.cumsum(np.eye(p["router"].shape[1], dtype=np.int64)[flat],
                     axis=0)[np.arange(flat.size), flat] - 1
    return rank < C


@pytest.mark.parametrize("glu,act,no_drop", [(True, "silu", False),
                                             (False, "gelu", False),
                                             (True, "silu", True)])
def test_moe_layer_matches_reference(glu, act, no_drop):
    import jax.numpy as jnp
    from repro.models.moe import moe_layer as ref_moe
    x, p = _moe_inputs(glu)
    kw = dict(top_k=2, capacity_factor=1.0, act=act, glu=glu,
              no_drop=no_drop)
    want, want_aux = ref_moe(jnp.asarray(x),
                             {k: jnp.asarray(v) for k, v in p.items()}, **kw)
    seen = []
    moe.moe_layer.tap = lambda **kv: seen.append(kv)
    try:
        got, aux = moe.moe_layer(torch.from_numpy(x),
                                 {k: torch.from_numpy(v)
                                  for k, v in p.items()}, **kw)
    finally:
        moe.moe_layer.tap = None
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=0,
                               atol=1e-6)
    (call,) = seen
    T = x.shape[0] * x.shape[1]
    assert call["capacity"] == (T if no_drop else int(1.0 * 2 * T / 8))
    kept = call["kept"].numpy()
    np.testing.assert_array_equal(
        kept, _reference_kept(x, p, 2, call["capacity"]))
    assert kept.all() if no_drop else (~kept).sum() > 0


def test_moe_top_k_breaks_ties_by_lower_expert():
    """Equal router probabilities: the lower expert indices win, as in
    `lax.top_k` (a zero router makes every expert tie)."""
    _, p = _moe_inputs(glu=True)
    p = {k: torch.from_numpy(v) for k, v in p.items()}
    p["router"] = torch.zeros_like(p["router"])
    seen = []
    moe.moe_layer.tap = lambda **kv: seen.append(kv)
    try:
        moe.moe_layer(torch.ones(3, 32), p, top_k=2, capacity_factor=8.0)
    finally:
        moe.moe_layer.tap = None
    # every pair picked experts 0 and 1: ranks 0..2 in each, all kept
    assert seen[0]["kept"].all()
    x = torch.randn(6, 32, generator=torch.Generator().manual_seed(0))
    out, _ = moe.moe_layer(x, p, top_k=2, capacity_factor=8.0)
    e01 = {k: v[:2] for k, v in p.items() if k != "router"}
    h = torch.nn.functional.silu(
        torch.einsum("td,edf->etf", x, e01["gate"])) * torch.einsum(
        "td,edf->etf", x, e01["up"])
    want = torch.einsum("etf,efd->td", h, e01["down"]) * 0.5
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)


def test_moe_layer_refuses_a_mesh():
    _, p = _moe_inputs(glu=True)
    p = {k: torch.from_numpy(v) for k, v in p.items()}
    with pytest.raises(NotImplementedError,
                       match=r"ROADMAP queue 1, items 7"):
        moe.moe_layer(torch.zeros(2, 32), p, top_k=2, capacity_factor=1.0,
                      mesh=object())


@pytest.mark.parametrize("S", [17, 32])
def test_rglru_prefill_and_decode_match_reference(S):
    import jax
    import jax.numpy as jnp
    from repro.models import blocks as ref_blocks
    rcfg, pcfg = _configs("recurrentgemma-2b", "float32")
    blk = pcfg.pattern[0]
    rp = ref_blocks.rglru_params(jax.random.key(5), rcfg)
    pp = {k: torch.from_numpy(np.array(v)) for k, v in rp.items()
          if k != "conv"}
    pp["conv"] = {"w": torch.from_numpy(np.array(rp["conv"]["w"]))}
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, S + 1, pcfg.d_model)).astype(np.float32)
    y_r, c_r = ref_blocks.rglru_forward(jnp.asarray(x[:, :S]), rp, rcfg,
                                        blk, "prefill", None, 0)
    y_p, c_p = blocks.rglru_forward(torch.from_numpy(x[:, :S]), pp, pcfg,
                                    blk, "prefill", None, 0)
    np.testing.assert_allclose(c_p["h"].numpy(), np.asarray(c_r["h"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(c_p["conv"].numpy(),
                                  np.asarray(c_r["conv"]))
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_r), rtol=1e-5,
                               atol=1e-5)
    y_r, c_r = ref_blocks.rglru_forward(jnp.asarray(x[:, S:]), rp, rcfg,
                                        blk, "decode", c_r, S)
    y_p, c_p = blocks.rglru_forward(torch.from_numpy(x[:, S:]), pp, pcfg,
                                    blk, "decode", c_p, S)
    np.testing.assert_allclose(c_p["h"].numpy(), np.asarray(c_r["h"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_r), rtol=1e-5,
                               atol=1e-5)


def test_sinusoidal_pos_matches_reference():
    import jax.numpy as jnp
    from repro.models.layers import sinusoidal_pos as ref_pos
    want = np.asarray(ref_pos(40, 24, jnp.float32))
    got = layers.sinusoidal_pos(40, 24, torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_every_family_builds_and_decodes_from_init_cache():
    """Every assigned family builds with `device="cpu"` (no refusal is
    left in `models/`) and decodes from `init_cache`."""
    from repro_torch.configs import list_archs
    for name in list_archs():
        cfg = smoke_variant(get_config(name)).replace(dtype=torch.float32)
        model = Model(cfg, device="cpu", seed=1)
        cache = model.init_cache(2, 24)
        logits, cache = model.decode(cache, torch.zeros((2, 1),
                                                        dtype=torch.int32))
        assert logits.shape == (2, cfg.padded_vocab), name
        assert bool(torch.isfinite(logits[:, :cfg.vocab]).all()), name
        assert cache["pos"] == 1, name


@pytest.mark.parametrize("name,S,extra", [FAMILIES[3], FAMILIES[4]])
def test_serving_steps_pass_frames_and_image_embeddings(name, S, extra):
    """`make_prefill_step` hands the whole batch to `Model.prefill`:
    its greedy tokens are the facade's on the same frames or image
    embeddings, and decode continues from its cache."""
    from repro_torch.launch.steps import make_decode_step, \
        make_prefill_step
    cfg = smoke_variant(get_config(name)).replace(dtype=torch.float32)
    model = Model(cfg, device="cpu", seed=2)
    batch = _port_batch(_batch(cfg, S, extra, seed=8))
    first, cache = make_prefill_step(model, pad_to=S + extra + 4)(batch)
    logits, _ = model.prefill(batch, pad_to=S + extra + 4)
    assert torch.equal(first, greedy_sample(logits))
    nxt, cache = make_decode_step(model)(cache, first[:, None])
    assert nxt.shape == (2, 1)
    assert cache["pos"] == S + (0 if cfg.is_encdec else extra) + 1


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name,S,extra", FAMILIES)
def test_card_path_matches_cpu_path(cuda_device, name, S, extra):
    """The same weights on the card (K3) and on the CPU (its plain
    version), float32: identical greedy tokens, logits within 1e-4."""
    cfg = smoke_variant(get_config(name)).replace(dtype=torch.float32)
    gpu = Model(cfg)
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    batch = _port_batch(_batch(cfg, S, extra, seed=6))
    pad_to = S + extra + STEPS
    launches = K3.decode_attention.launches
    gl, gc = gpu.prefill({k: v.to(cuda_device) for k, v in batch.items()},
                         pad_to=pad_to)
    cl, cc = cpu.prefill(batch, pad_to=pad_to)
    for _ in range(STEPS):
        torch.testing.assert_close(gl.cpu(), cl, rtol=1e-4, atol=1e-4)
        gt, ct = greedy_sample(gl)[:, None], greedy_sample(cl)[:, None]
        assert torch.equal(gt.cpu(), ct)
        gl, gc = gpu.decode(gc, gt)
        cl, cc = cpu.decode(cc, ct)
    assert K3.decode_attention.launches - launches == \
        _attn_calls_per_step(cfg) * STEPS

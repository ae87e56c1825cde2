"""The port's model-zoo serving path (`repro_torch.models`) against the
reference `repro.models`.

Weights are the reference's, drawn by `repro.models.Model.init` and
carried over with `repro_torch.models.bridge.params_from_jax`; prompts
come from a seeded numpy generator. Both packages run on the CPU: the
port's attention decode through K3's plain version, its SSD prefill
through K4's plain version.

  * float32 (`cfg.replace(dtype=float32)`): prefill, then 8 greedy
    decode steps on the smoke variants of qwen2.5-3b, qwen3-0.6b
    (qk_norm), gemma3-27b (six-slot pattern with 16-slot windows, one
    remainder layer, embed_scale set to 8) and mamba2-1.3b. Greedy
    tokens identical at every step; logits within rtol = atol = 1e-4.
  * bfloat16: the same runs, both fed the reference's greedy tokens;
    logits within atol 5e-2 (logits are about 0.6 in size). The two
    frameworks round bf16 activations at different places (XLA fuses
    elementwise chains in float32, eager torch rounds after each op),
    and K4 keeps the SSD's intra-chunk product in float32 where the
    reference model rounds it to bf16.
  * one decode step alone, from the reference's prefill cache carried
    over with `bridge.cache_from_jax`, at the float32 tolerance.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, QWEN25_POOL, get_config, \
    list_archs, smoke_variant
from repro_torch.kernels import decode_attention as K3
from repro_torch.kernels import ssd_scan as K4
from repro_torch.models import Model, greedy_sample
from repro_torch.models import attention, layers
from repro_torch.models.bridge import cache_from_jax, params_from_jax

ARCH_CASES = [("qwen2.5-3b", 32), ("qwen3-0.6b", 32), ("gemma3-27b", 32),
              ("mamba2-1.3b", 20)]
STEPS = 8


def _configs(name, dtype):
    import jax.numpy as jnp
    from repro.configs import get_config as ref_get
    from repro.configs import smoke_variant as ref_smoke
    rcfg = ref_smoke(ref_get(name)).replace(dtype=getattr(jnp, dtype))
    pcfg = smoke_variant(get_config(name)).replace(
        dtype=getattr(torch, dtype))
    if name == "gemma3-27b":    # the smoke variant resets it to 1
        rcfg, pcfg = (c.replace(embed_scale=8.0) for c in (rcfg, pcfg))
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


def _prompt(S, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (2, S)).astype(
        np.int32)


def _ref_steps(ref, params, toks, pad_to):
    import jax
    import jax.numpy as jnp
    prefill = jax.jit(lambda p, t: ref.prefill(p, {"tokens": t},
                                               pad_to=pad_to))
    return prefill(params, jnp.asarray(toks)), jax.jit(ref.decode)


@pytest.mark.parametrize("name,S", ARCH_CASES)
def test_prefill_and_greedy_decode_match_reference_f32(pair, name, S):
    import jax.numpy as jnp
    ref, params, port = pair(name, "float32")
    toks = _prompt(S)
    (rl, rc), rdec = _ref_steps(ref, params, toks, S + STEPS)
    counts = (K3.decode_attention.plain_calls, K4.ssd_scan.plain_calls)
    pl, pc = port.prefill({"tokens": torch.from_numpy(toks)},
                          pad_to=S + STEPS)
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
    assert pc["pos"] == S + STEPS
    n_attn = sum(b.mixer == "attn" for b in port.cfg.layer_types)
    n_ssd = sum(b.mixer == "ssd" for b in port.cfg.layer_types)
    assert K3.decode_attention.plain_calls - counts[0] == n_attn * STEPS
    assert K4.ssd_scan.plain_calls - counts[1] == n_ssd


@pytest.mark.parametrize("name,S", ARCH_CASES)
def test_prefill_and_decode_match_reference_bf16(pair, name, S):
    import jax.numpy as jnp
    ref, params, port = pair(name, "bfloat16")
    toks = _prompt(S, seed=1)
    (rl, rc), rdec = _ref_steps(ref, params, toks, S + STEPS)
    pl, pc = port.prefill({"tokens": torch.from_numpy(toks)},
                          pad_to=S + STEPS)
    for step in range(STEPS + 1):
        assert pl.dtype == torch.float32
        np.testing.assert_allclose(pl.numpy(), np.asarray(rl), rtol=0,
                                   atol=5e-2, err_msg=f"step {step}")
        if step == STEPS:
            break
        rt = jnp.argmax(rl, -1).astype(jnp.int32)[:, None]
        rl, rc = rdec(params, rc, rt)
        pl, pc = port.decode(pc, torch.from_numpy(np.array(rt)))


@pytest.mark.parametrize("name,S", [("qwen3-0.6b", 32), ("gemma3-27b", 32),
                                    ("mamba2-1.3b", 20)])
def test_one_decode_step_from_reference_cache(pair, name, S):
    """The reference's prefill cache, carried over, gives the reference's
    next logits after one port decode step (ring-buffer slots, windowed
    caches and the SSD state/conv windows all carried)."""
    import jax
    import jax.numpy as jnp
    ref, params, port = pair(name, "float32")
    toks = _prompt(S, seed=2)
    (rl, rc), rdec = _ref_steps(ref, params, toks, S + 4)
    rt = jnp.argmax(rl, -1).astype(jnp.int32)[:, None]
    want, _ = rdec(params, rc, rt)
    cache = cache_from_jax(jax.tree.map(np.asarray, rc), port.cfg,
                           device="cpu")
    assert cache["pos"] == S
    got, _ = port.decode(cache, torch.from_numpy(np.array(rt)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_bridge_reads_bfloat16_bits_exactly(pair):
    """bf16 leaves keep their bits; slot s of cycle c is layer
    c * len(pattern) + s, and the remainder layers come last."""
    import jax

    def as_f32(a):
        return torch.from_numpy(np.asarray(a).astype(np.float32))

    ref, params, port = pair("qwen3-0.6b", "bfloat16")   # 2 cycles of 1
    assert np.asarray(params["slot0"]["mixer"]["wq"]).dtype.name == \
        "bfloat16"
    state = params_from_jax(jax.tree.map(np.asarray, params), port.cfg)
    got = state["layers.1.mixer.wq"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.float(),
                       as_f32(params["slot0"]["mixer"]["wq"])[1])
    ref, params, port = pair("gemma3-27b", "bfloat16")   # 1 cycle of 6 + 1
    state = params_from_jax(jax.tree.map(np.asarray, params), port.cfg)
    assert torch.equal(state["layers.2.mlp.up"].float(),
                       as_f32(params["slot2"]["mlp"]["up"])[0])
    assert torch.equal(state["layers.6.mixer.wk"].float(),
                       as_f32(params["rem0"]["mixer"]["wk"]))


@pytest.mark.parametrize("name", list_archs() + sorted(QWEN25_POOL))
def test_registry_matches_reference(name):
    import dataclasses
    from repro.configs import get_config as ref_get
    from repro.configs import smoke_variant as ref_smoke
    for port_cfg, ref_cfg in ((get_config(name), ref_get(name)),
                              (smoke_variant(get_config(name)),
                               ref_smoke(ref_get(name)))):
        a, b = dataclasses.asdict(port_cfg), dataclasses.asdict(ref_cfg)
        assert a.pop("dtype") == torch.bfloat16
        b.pop("dtype")
        assert a == b
        assert port_cfg.param_counts() == ref_cfg.param_counts()
        assert port_cfg.padded_vocab == ref_cfg.padded_vocab
    assert name in ARCHS or name in QWEN25_POOL


@pytest.mark.parametrize("pool", ["paper", "assigned"])
def test_tiers_on_the_ported_registry_match_reference(pool):
    from repro.serving import tiers as ref_tiers
    from repro_torch.serving import tiers
    got = getattr(tiers, f"{pool}_pool_tiers")()
    want = getattr(ref_tiers, f"{pool}_pool_tiers")()
    assert tiers.tpot_table(got) == ref_tiers.tpot_table(want)
    for g, w in zip(got, want, strict=True):
        assert (g.name, g.n_params, g.kv_bytes_per_token) == \
            (w.name, w.n_params, w.kv_bytes_per_token)
        for b, ctx in ((1, 64), (8, 500), (48, 4000)):
            assert g.tpot(b, ctx) == w.tpot(b, ctx)
        assert g.prefill_time(700) == w.prefill_time(700)
        assert g.cost(512, 300) == w.cost(512, 300)


@pytest.mark.parametrize("act,glu", [("silu", True), ("gelu", True),
                                     ("gelu", False)])
def test_layers_match_reference(act, glu):
    import jax.numpy as jnp
    from repro.models import layers as ref
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32) * 0.1
    bias = rng.normal(size=(16,)).astype(np.float32)
    pos = np.arange(5)[None, :] + 100
    tx = torch.from_numpy(x)
    checks = [
        (layers.rms_norm(tx, torch.from_numpy(scale)),
         ref.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        (layers.layer_norm(tx, torch.from_numpy(scale),
                           torch.from_numpy(bias)),
         ref.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                        jnp.asarray(bias))),
        (layers.apply_rope(tx, torch.from_numpy(pos), 1e6),
         ref.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
    ]
    w = {k: rng.normal(size=s).astype(np.float32) * 0.2 for k, s in
         (("up", (16, 24)), ("gate", (16, 24)), ("down", (24, 16)))}
    checks.append((layers.mlp(tx, {k: torch.from_numpy(v)
                                   for k, v in w.items()}, act, glu),
                   ref.mlp(jnp.asarray(x), {k: jnp.asarray(v)
                                            for k, v in w.items()},
                           act, glu)))
    for got, want in checks:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("causal,window,kv_len,block", [
    (True, 0, None, 16), (True, 24, None, 16), (False, 0, 40, 32),
    (True, 0, None, 48)])
def test_flash_attention_forward_matches_reference(causal, window, kv_len,
                                                   block):
    import jax.numpy as jnp
    from repro.models.attention import flash_attention as ref_flash
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(size=(2, 64, 4, 16)).astype(np.float32)
               for _ in range(3))
    want = ref_flash(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                     window=window, kv_len=kv_len, block_q=block,
                     block_kv=block)
    got = attention.flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        window=window, kv_len=kv_len, block_q=block, block_kv=block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_repeat_kv_matches_reference():
    import jax.numpy as jnp
    from repro.models.attention import repeat_kv as ref_repeat
    x = np.arange(2 * 3 * 2 * 4, dtype=np.float32).reshape(2, 3, 2, 4)
    np.testing.assert_array_equal(
        attention.repeat_kv(torch.from_numpy(x), 3).numpy(),
        np.asarray(ref_repeat(jnp.asarray(x), 3)))


def test_cache_bridge_runs_on_the_card_unless_asked():
    """`cache_from_jax(device=None)` means the card, as every entry point
    of the port: without one it raises; `device="cpu"` stays on the CPU."""
    cfg = smoke_variant(get_config("mamba2-1.3b"))
    layer = {"state": np.ones((cfg.n_cycles, 2, 3), np.float32)}
    tree = {"pos": np.int32(5), "slot0": layer}
    cache = cache_from_jax(tree, cfg, device="cpu")
    assert cache["pos"] == 5 and len(cache["layers"]) == cfg.n_layers
    assert cache["layers"][0]["state"].device.type == "cpu"
    if torch.cuda.is_available():
        on_card = cache_from_jax(tree, cfg)
        assert on_card["layers"][0]["state"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cache_from_jax(tree, cfg)


def test_serving_steps_are_prefill_then_greedy_decode():
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    cfg = smoke_variant(get_config("qwen2.5-3b")).replace(
        dtype=torch.float32)
    model = Model(cfg, device="cpu", seed=3)
    toks = torch.from_numpy(_prompt(12, seed=5))
    first, cache = make_prefill_step(model, pad_to=16)({"tokens": toks})
    logits, _ = model.prefill({"tokens": toks}, pad_to=16)
    assert torch.equal(first, greedy_sample(logits))
    assert first.dtype == torch.int32 and first.shape == (2,)
    nxt, cache = make_decode_step(model)(cache, first[:, None])
    assert nxt.shape == (2, 1) and cache["pos"] == 13


def test_init_is_seeded_and_cache_spec_fits():
    cfg = smoke_variant(get_config("mamba2-1.3b")).replace(
        dtype=torch.float32)
    a, b = Model(cfg, device="cpu", seed=7), Model(cfg, device="cpu")
    assert not torch.equal(a.embed, b.embed)
    b.init(7)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    cache = a.init_cache(2, 24)
    assert cache["pos"] == 0 and len(cache["layers"]) == cfg.n_layers
    assert cache["layers"][0]["state"].shape == (2, cfg.ssm_heads,
                                                 cfg.ssm_head_dim,
                                                 cfg.ssm_state)
    assert math.isclose(a.embed.float().std().item(), 0.02, rel_tol=0.1)


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name,S", ARCH_CASES)
def test_card_path_matches_cpu_path(cuda_device, name, S):
    """The same weights on the card (K3/K4 kernels) and on the CPU (their
    plain versions), float32: identical greedy tokens, logits within
    1e-4."""
    cfg = smoke_variant(get_config(name)).replace(dtype=torch.float32)
    gpu = Model(cfg)
    cpu = Model(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    toks = torch.from_numpy(_prompt(S, seed=6))
    gl, gc = gpu.prefill({"tokens": toks}, pad_to=S + STEPS)
    cl, cc = cpu.prefill({"tokens": toks}, pad_to=S + STEPS)
    for _ in range(STEPS):
        torch.testing.assert_close(gl.cpu(), cl, rtol=1e-4, atol=1e-4)
        gt, ct = greedy_sample(gl)[:, None], greedy_sample(cl)[:, None]
        assert torch.equal(gt.cpu(), ct)
        gl, gc = gpu.decode(gc, gt)
        cl, cc = cpu.decode(cc, ct)

"""The port's differentiable flash attention against the reference's
hand-written VJP (`repro.models.attention.flash_attention`, a
`jax.custom_vjp`), on the same seeded numpy inputs, both on the CPU.

The output and dq / dk / dv come from `jax.vjp` and from torch's
autograd with the same cotangent: causal and bidirectional, a sliding
window, a length the block does not divide (one block of the whole
length), K/V heads repeated for GQA (gradients summed back onto the K
heads by each package's `repeat_kv`). Tolerances, relative to each
tensor's largest magnitude: float32 1e-5 (the two sum their blocks'
products in other orders); bfloat16 2^-7, one unit in the last place
(both round the same float32 values to bfloat16, which a last-bit
difference in float32 can tip).

The backward keeps no tensor of S x S elements between the passes:
`torch.autograd.graph.saved_tensors_hooks` sees exactly q, k, v, o and
the blocked lse saved.
"""
import numpy as np
import pytest
import torch

from repro_torch.models.attention import flash_attention, repeat_kv

# (causal, window, S, block, H, K)
CASES = [
    (True, 0, 64, 16, 4, 4),
    (False, 0, 64, 16, 4, 4),
    (True, 24, 64, 16, 4, 4),
    (True, 0, 40, 16, 4, 4),      # 40 % 16 != 0: one block of 40
    (True, 0, 64, 16, 4, 2),      # GQA: 2 K/V heads repeated to 4
    (True, 8, 48, 16, 6, 2),      # window and GQA, three blocks
]
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}


def _inputs(S, H, K, d=16, B=2, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, d), dtype=np.float32)
    k = rng.standard_normal((B, S, K, d), dtype=np.float32)
    v = rng.standard_normal((B, S, K, d), dtype=np.float32)
    g = rng.standard_normal((B, S, H, d), dtype=np.float32)
    return q, k, v, g


def _reference(q, k, v, g, causal, window, block, dtype):
    import jax
    import jax.numpy as jnp
    from repro.models import attention as ref
    H, K = q.shape[2], k.shape[2]
    jdt = getattr(jnp, dtype)

    def f(q, k, v):
        return ref.flash_attention(q, ref.repeat_kv(k, H // K),
                                   ref.repeat_kv(v, H // K), causal=causal,
                                   window=window, block_q=block,
                                   block_kv=block)
    o, vjp = jax.vjp(f, *(jnp.asarray(x, jdt) for x in (q, k, v)))
    grads = vjp(jnp.asarray(g, jdt))
    return [np.asarray(x.astype(jnp.float32)) for x in (o, *grads)]


def _port(q, k, v, g, causal, window, block, dtype):
    H, K = q.shape[2], k.shape[2]
    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to(tdt).requires_grad_() for x in
               (q, k, v))
    o = flash_attention(q, repeat_kv(k, H // K), repeat_kv(v, H // K),
                        causal=causal, window=window, block_q=block,
                        block_kv=block)
    o.backward(torch.from_numpy(g).to(tdt))
    return [x.detach().float().numpy() for x in (o, q.grad, k.grad, v.grad)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window,S,block,H,K", CASES)
def test_forward_and_vjp_match_reference(causal, window, S, block, H, K,
                                         dtype):
    q, k, v, g = _inputs(S, H, K)
    want = _reference(q, k, v, g, causal, window, block, dtype)
    got = _port(q, k, v, g, causal, window, block, dtype)
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        scale = float(np.abs(b).max())
        err = float(np.abs(a - b).max())
        assert err <= TOL[dtype] * scale, (name, err, scale)


def test_prefill_path_is_the_forward_without_a_graph():
    """Inputs that need no gradient give the same output and record no
    graph (the serving path)."""
    q, k, v, _ = _inputs(64, 4, 4)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    o = flash_attention(*t, causal=True, block_q=16, block_kv=16)
    assert o.grad_fn is None
    want = _port(q, k, v, np.zeros_like(q), True, 0, 16, "float32")[0]
    np.testing.assert_array_equal(o.numpy(), want)


def test_backward_saves_no_s_by_s_tensor():
    S, H, d = 256, 2, 8
    q, k, v, g = _inputs(S, H, H, d=d, B=1)
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        o = flash_attention(q, k, v, causal=True, block_q=32, block_kv=32)
    o.backward(torch.from_numpy(g))
    assert sorted(saved) == sorted([(1, S, H, d)] * 4 + [(1, S // 32, H, 32)])
    assert max(int(np.prod(s)) for s in saved) < S * S
    assert q.grad is not None and torch.isfinite(q.grad).all()

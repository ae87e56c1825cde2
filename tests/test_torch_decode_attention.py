"""The port's K3 (`repro_torch.kernels.decode_attention`) against the
Pallas reference.

On the CPU the wrapper runs its plain version (the cache cut into
64-slot pieces, a float32 (m, l, acc) per piece, then the merge). It is
held against `repro.kernels.decode_attention.decode_attention` (the
Pallas kernel in interpret mode) and `repro.kernels.ref.
decode_attention_ref` (the model's masked softmax) on the shapes of
`tests/test_kernels.py::test_decode_attention` plus a full-width head
shape (K = 2, g = 8, d = 128), each with its window and with a window
added, in float32 and bfloat16. Tolerances are the reference's own:
2e-5 in float32 and 4e-2 in bfloat16 (rtol = atol). Inputs come from a
seeded numpy generator.

The CUDA kernel is held against the plain version by the tests marked
`cuda`, which skip without a card.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as K3

# (B, C, K, g, d, window, tile): tests/test_kernels.py's four, then the
# full-width heads of qwen2.5-3b (C = 300 spans five 64-slot pieces)
SHAPES = [(2, 128, 2, 2, 32, 0, 64), (1, 513, 4, 1, 64, 0, 128),
          (3, 96, 1, 6, 16, 32, 32), (2, 64, 8, 1, 16, 0, 64),
          (2, 300, 2, 8, 128, 0, 128)]


def _inputs(seed, B, C, K, g, d, empty_from=None):
    rng = np.random.default_rng(seed)
    H = K * g
    q = rng.normal(size=(B, H, d)).astype(np.float32)
    kc = rng.normal(size=(B, C, K, d)).astype(np.float32)
    vc = rng.normal(size=(B, C, K, d)).astype(np.float32)
    pos = C - 5 if empty_from is None else empty_from - 1
    cpos = np.where(np.arange(C) <= pos, np.arange(C), -1).astype(np.int32)
    return q, kc, vc, cpos, pos


def _torch(arrays, dtype):
    q, kc, vc, cpos = arrays
    return (torch.from_numpy(q).to(dtype), torch.from_numpy(kc).to(dtype),
            torch.from_numpy(vc).to(dtype), torch.from_numpy(cpos))


@pytest.mark.parametrize("B,C,K,g,d,window,tile", SHAPES)
@pytest.mark.parametrize("extra_window", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_and_model_reference(B, C, K, g, d, window,
                                                  tile, extra_window, dtype):
    import jax.numpy as jnp      # here: the card's machine has no jax
    from repro.kernels import ref as kref
    from repro.kernels.decode_attention import decode_attention as pallas
    if extra_window:
        window = window or C // 3
    q, kc, vc, cpos, pos = _inputs(B * C + g, B, C, K, g, d)
    jdt = getattr(jnp, dtype)
    jargs = (jnp.asarray(q, jdt), jnp.asarray(kc, jdt), jnp.asarray(vc, jdt),
             jnp.asarray(cpos))
    want_k = pallas(*jargs, pos, window=window, tile=tile, interpret=True)
    want_r = kref.decode_attention_ref(*jargs, pos, window=window)
    before = K3.decode_attention.plain_calls
    args = _torch((q, kc, vc, cpos), getattr(torch, dtype))
    got = K3.decode_attention(*args, pos, window)
    assert K3.decode_attention.plain_calls == before + 1
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, K * g, d)
    tol = 4e-2 if dtype == "bfloat16" else 2e-5
    for want in (want_k, want_r):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


def test_partly_empty_cache_reads_only_valid_slots():
    """Slots past pos are empty (-1); garbage in them changes nothing."""
    q, kc, vc, cpos, pos = _inputs(3, 2, 200, 2, 4, 32, empty_from=70)
    args = _torch((q, kc, vc, cpos), torch.float32)
    a = K3.decode_attention(*args, pos)
    kc2, vc2 = kc.copy(), vc.copy()
    kc2[:, 70:], vc2[:, 70:] = 1e4, -1e4
    b = K3.decode_attention(*_torch((q, kc2, vc2, cpos), torch.float32), pos)
    assert torch.equal(a, b)
    # the same attention over the valid slots alone
    c = K3.decode_attention(*_torch((q, kc[:, :70].copy(), vc[:, :70].copy(),
                                     cpos[:70].copy()), torch.float32), pos)
    torch.testing.assert_close(a, c, rtol=2e-6, atol=2e-6)


def test_fully_masked_row_gives_zero():
    q, kc, vc, cpos, _ = _inputs(4, 1, 80, 1, 2, 16)
    cpos[:] = -1
    out = K3.decode_attention(*_torch((q, kc, vc, cpos), torch.float32), 10)
    assert torch.equal(out, torch.zeros_like(out))


def test_ring_buffer_positions_and_window():
    """Slots hold positions out of order (a wrapped ring buffer); the
    result is the softmax over the positions inside the window."""
    rng = np.random.default_rng(5)
    B, C, K, g, d, pos, window = 2, 96, 2, 3, 16, 150, 40
    q = rng.normal(size=(B, K * g, d)).astype(np.float32)
    kc = rng.normal(size=(B, C, K, d)).astype(np.float32)
    vc = rng.normal(size=(B, C, K, d)).astype(np.float32)
    cpos = np.array([pos - ((pos - j) % C) for j in range(C)], np.int32)
    got = K3.decode_attention(*_torch((q, kc, vc, cpos), torch.float32), pos,
                              window)
    ok = (cpos > pos - window) & (cpos <= pos)
    qg = q.reshape(B, K, g, d).astype(np.float64)
    s = np.einsum("bkgd,bckd->bkgc", qg, kc) / np.sqrt(d)
    s = np.where(ok, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    want = np.einsum("bkgc,bckd->bkgd", p, vc).reshape(B, K * g, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", ["dtype_mix", "heads", "positions",
                                  "contiguous", "groups", "pos_type"])
def test_wrapper_refuses_what_the_kernel_cannot_take(case):
    q, kc, vc, cpos, pos = _inputs(6, 2, 40, 2, 2, 16)
    q, kc, vc, cpos = _torch((q, kc, vc, cpos), torch.float32)
    if case == "dtype_mix":
        kc = kc.to(torch.bfloat16)
    elif case == "heads":
        q = q[:, :3].contiguous()
    elif case == "positions":
        cpos = cpos.long()
    elif case == "contiguous":
        kc = kc.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "groups":
        q = torch.zeros((2, 2 * 33, 16))
    else:
        pos = torch.tensor(pos)
    before = K3.decode_attention.plain_calls
    with pytest.raises((ValueError, TypeError)):
        K3.decode_attention(q, kc, vc, cpos, pos)
    assert K3.decode_attention.plain_calls == before


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,K,g,d,window,empty_from", [
    (8, 1024, 2, 8, 128, 0, 540), (8, 1024, 2, 8, 128, 256, None),
    (2, 64, 2, 2, 16, 0, None), (3, 96, 1, 6, 16, 32, 50)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(cuda_device, B, C, K, g, d, window,
                                      empty_from, dtype):
    """Same pieces, same merge: float32 within 2e-6, bfloat16 within one
    unit in the last place of the output (2^-7 relative)."""
    q, kc, vc, cpos, pos = _inputs(B + C, B, C, K, g, d, empty_from)
    args = [t.to(cuda_device) for t in _torch((q, kc, vc, cpos), dtype)]
    launches = K3.decode_attention.launches
    got = K3.decode_attention(*args, pos, window)
    torch.cuda.synchronize()
    assert K3.decode_attention.launches == launches + 1
    want = K3.decode_attention_plain(*args, pos, window)
    tol = 2 ** -7 if dtype == torch.bfloat16 else 2e-6
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)

"""The port's K3 (`repro_torch.kernels.decode_attention`) against the
Pallas reference.

On the CPU the wrapper runs its plain version (the cache cut into the
kernel's pieces of whole 64-slot tiles, a float32 (m, l, acc) per piece
and segment, then the merges). It is
held against `repro.kernels.decode_attention.decode_attention` (the
Pallas kernel in interpret mode) and `repro.kernels.ref.
decode_attention_ref` (the model's masked softmax) on the shapes of
`tests/test_kernels.py::test_decode_attention` plus a full-width head
shape (K = 2, g = 8, d = 128) and a long cache of 32 heads whose pieces
take two segments each, each with its window and with a window
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
# full-width heads of qwen2.5-3b (C = 300 spans five 64-slot pieces),
# then 32 heads over 40 tiles (8 pieces of 5 tiles, segments of 4)
SHAPES = [(2, 128, 2, 2, 32, 0, 64), (1, 513, 4, 1, 64, 0, 128),
          (3, 96, 1, 6, 16, 32, 32), (2, 64, 8, 1, 16, 0, 64),
          (2, 300, 2, 8, 128, 0, 128), (1, 2560, 1, 32, 8, 0, 128)]


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


@pytest.mark.parametrize("B,K,C,g,want", [
    (1, 1, 40, 2, (1, 1, 1)),          # C < 64: one tile
    (2, 2, 300, 8, (5, 1, 1)),         # C not a multiple of 64: five tiles
    (132, 2, 1024, 8, (1, 16, 16)),    # B K >= 264: one piece
    (8, 2, 1024, 8, (8, 2, 2)),        # the serving shape: 8 pieces
    (1, 1, 576, 8, (5, 2, 2)),         # 9 tiles: 8 wanted, 5 of 2 tiles
    (1, 1, 2560, 32, (8, 5, 4)),       # pieces of two segments
    (1, 8, 32768, 4, (8, 64, 32))])    # a long cache
def test_pieces_layout(B, K, C, g, want):
    S, n_per, U = K3.pieces(B, K, C, g)
    assert (S, n_per, U) == want
    n_tiles = -(-C // K3.TILE)
    assert 1 <= S <= K3.MAX_PIECES and (S - 1) * n_per < n_tiles <= S * n_per
    assert U * g * K3.TILE <= K3.SCORE_SLOTS or U == 1


@pytest.mark.parametrize("d", [8, 16, 128])
def test_dots_follow_the_kernel_order(d):
    """Scores are summed as the kernel sums them: eight partial sums, the
    x-th over e = x mod 8 ascending, then added in order, each product
    and each sum rounded to float32."""
    rng = np.random.default_rng(d)
    q = rng.normal(size=(1, 1, 2, d)).astype(np.float32)
    k = rng.normal(size=(1, 1, 1, 3, 1, d)).astype(np.float32)
    got = K3._dots(torch.from_numpy(q), torch.from_numpy(k)).numpy()
    for h in range(2):
        for c in range(3):
            part = [np.float32(0)] * 8
            for e in range(d):
                part[e % 8] = np.float32(part[e % 8] + np.float32(
                    q[0, 0, h, e] * k[0, 0, 0, c, 0, e]))
            dot = part[0]
            for x in range(1, 8):
                dot = np.float32(dot + part[x])
            assert got[0, 0, 0, 0, h, c] == dot


def test_pieces_ignore_the_device(monkeypatch):
    """The layout is the shape's alone: with every device query broken,
    `pieces` and the plain version give what they gave."""
    q, kc, vc, cpos, pos = _inputs(8, 2, 300, 2, 8, 16)
    args = _torch((q, kc, vc, cpos), torch.float32)
    want = (K3.pieces(2, 2, 300, 8), K3.decode_attention(*args, pos))

    def broken(*a, **kw):
        raise AssertionError("the layout read the device")
    for name in ("get_device_properties", "device_count", "is_available",
                 "current_device", "get_device_name"):
        monkeypatch.setattr(torch.cuda, name, broken)
    assert K3.pieces(2, 2, 300, 8) == want[0]
    assert torch.equal(K3.decode_attention(*args, pos), want[1])


def test_window_that_empties_whole_tiles_reads_none_of_them():
    """A window leaves tiles 0-5 of 8 without a valid slot: NaN in them
    changes nothing, and the result is the windowed softmax."""
    rng = np.random.default_rng(11)
    B, C, K, g, d, pos, window = 2, 512, 2, 4, 16, 500, 100
    q = rng.normal(size=(B, K * g, d)).astype(np.float32)
    kc = rng.normal(size=(B, C, K, d)).astype(np.float32)
    vc = rng.normal(size=(B, C, K, d)).astype(np.float32)
    cpos = np.arange(C, dtype=np.int32)
    cpos[pos + 1:] = -1
    a = K3.decode_attention(*_torch((q, kc, vc, cpos), torch.float32), pos,
                            window)
    kc[:, :384], vc[:, :384] = np.nan, np.nan
    b = K3.decode_attention(*_torch((q, kc, vc, cpos), torch.float32), pos,
                            window)
    assert torch.equal(a, b)
    ok = (cpos > pos - window) & (cpos <= pos)
    s = np.einsum("bkgd,bckd->bkgc", q.reshape(B, K, g, d).astype(np.float64),
                  np.where(ok[None, :, None, None], kc, 0)) / np.sqrt(d)
    s = np.where(ok, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    want = np.einsum("bkgc,bckd->bkgd", p,
                     np.where(ok[None, :, None, None], vc, 0))
    np.testing.assert_allclose(a.numpy(), want.reshape(B, K * g, d),
                               rtol=2e-5, atol=2e-5)


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


def _close_on_card(got, want, dtype):
    """float32 within 1e-5 of the output's scale; bfloat16 within one unit
    in the last place (2^-7 relative) plus that."""
    got, want = got.float(), want.float()
    atol = 1e-5 * max(1.0, float(want.abs().max()))
    rtol = 2 ** -7 if dtype == torch.bfloat16 else 0.0
    assert bool(((got - want).abs() <= rtol * want.abs() + atol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("S", range(1, 9))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_at_every_cluster_size(cuda_device, S, dtype):
    """One row and one kv head over S tiles: a cluster of S pieces."""
    C = 64 * S
    assert K3.pieces(1, 1, C, 8)[0] == S
    q, kc, vc, cpos, pos = _inputs(S, 1, C, 1, 8, 128, empty_from=C - 3)
    args = [t.to(cuda_device) for t in _torch((q, kc, vc, cpos), dtype)]
    got = K3.decode_attention(*args, pos)
    torch.cuda.synchronize()
    _close_on_card(got, K3.decode_attention_plain(*args, pos), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C,K,g,d", [(8, 1024, 2, 8, 128),
                                       (1, 2560, 1, 32, 8)])
def test_kernel_on_a_wrapped_ring_buffer(cuda_device, dtype, B, C, K, g, d):
    """Slots hold positions out of order (a ring buffer past its end),
    with a window; the second shape walks its pieces in two segments."""
    rng = np.random.default_rng(C)
    pos, window = C + 300, C - 200
    q = rng.normal(size=(B, K * g, d)).astype(np.float32)
    kc = rng.normal(size=(B, C, K, d)).astype(np.float32)
    vc = rng.normal(size=(B, C, K, d)).astype(np.float32)
    cpos = np.array([pos - ((pos - j) % C) for j in range(C)], np.int32)
    args = [t.to(cuda_device) for t in _torch((q, kc, vc, cpos), dtype)]
    got = K3.decode_attention(*args, pos, window)
    torch.cuda.synchronize()
    _close_on_card(got, K3.decode_attention_plain(*args, pos, window), dtype)


@pytest.mark.cuda
def test_kernel_allocates_only_its_output(cuda_device):
    q, kc, vc, cpos, pos = _inputs(1, 8, 1024, 2, 8, 128, empty_from=544)
    args = [t.to(cuda_device) for t in _torch((q, kc, vc, cpos),
                                              torch.bfloat16)]
    K3.decode_attention(*args, pos)                  # builds, warms
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    out = K3.decode_attention(*args, pos)
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == before + 1
    assert out.shape == (8, 16, 128)

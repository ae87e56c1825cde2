"""The port's K4 (`repro_torch.kernels.ssd_scan`) against the Pallas
reference and the SSD recurrence.

On the CPU the wrapper runs its plain version, one chunk at a time. It
is held against `repro.kernels.ssd_scan.ssd_scan` (the Pallas kernel in
interpret mode) on the shapes of `tests/test_kernels.py::test_ssd_scan`
within 1e-4 (the same algorithm, summed in another order), and against
the token-by-token recurrence `repro.kernels.ref.ssd_recurrent_ref` and
the model's `repro.models.blocks._ssd_chunked` with grouped B/C within
the reference's 2e-3. Inputs come from a seeded numpy generator.

The CUDA kernel is held against the plain version by the tests marked
`cuda`, which skip without a card.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ssd_scan as K4

# (B, S, nh, P, N, chunk, head_tile): tests/test_kernels.py's three
SHAPES = [(2, 64, 4, 16, 16, 16, 2), (1, 96, 8, 8, 32, 32, 8),
          (2, 32, 2, 16, 64, 16, 1)]


def _inputs(seed, B, S, nh, P, N, G=None):
    rng = np.random.default_rng(seed)
    G = nh if G is None else G
    f32 = np.float32
    xh = rng.normal(size=(B, S, nh, P)).astype(f32)
    Bm = (rng.normal(size=(B, S, G, N)) * 0.5).astype(f32)
    Cm = (rng.normal(size=(B, S, G, N)) * 0.5).astype(f32)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, nh)))).astype(f32)
    A = (-np.exp(rng.normal(size=(nh,)) * 0.3)).astype(f32)
    return xh, Bm, Cm, dt, A


def _port(arrays, x_dtype=torch.float32):
    xh, *rest = arrays
    return [torch.from_numpy(xh).to(x_dtype)] + [torch.from_numpy(a)
                                                  for a in rest]


@pytest.mark.parametrize("B,S,nh,P,N,chunk,hb", SHAPES)
def test_plain_matches_pallas(B, S, nh, P, N, chunk, hb):
    import jax.numpy as jnp      # here: the card's machine has no jax
    from repro.kernels.ssd_scan import ssd_scan as pallas
    arrays = _inputs(B * S + nh, B, S, nh, P, N)
    yr, sr = pallas(*(jnp.asarray(a) for a in arrays), chunk=chunk,
                    head_tile=hb, interpret=True)
    before = K4.ssd_scan.plain_calls
    y, st = K4.ssd_scan(*_port(arrays), chunk=chunk)
    assert K4.ssd_scan.plain_calls == before + 1
    assert y.dtype == torch.float32 and st.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(sr), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("B,S,nh,P,N,chunk,hb", SHAPES)
def test_plain_matches_recurrence(B, S, nh, P, N, chunk, hb):
    import jax.numpy as jnp
    from repro.kernels import ref as kref
    arrays = _inputs(7 + S, B, S, nh, P, N)
    yr, sr = kref.ssd_recurrent_ref(*(jnp.asarray(a) for a in arrays))
    y, st = K4.ssd_scan(*_port(arrays), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(st.numpy(), np.asarray(sr), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("G", [1, 2])
def test_grouped_bc_matches_model_chunked_path(G):
    """Grouped B/C (head h reads group h // (nh / G)) against the model's
    `_ssd_chunked`, which repeats the groups over the heads."""
    import jax.numpy as jnp
    from repro.models.blocks import _ssd_chunked
    B, S, nh, P, N = 2, 64, 4, 8, 16
    arrays = _inputs(11 + G, B, S, nh, P, N, G=G)
    init = jnp.zeros((B, nh, P, N), jnp.float32)
    yr, sr = _ssd_chunked(*(jnp.asarray(a) for a in arrays), 16, init)
    y, st = K4.ssd_scan(*_port(arrays), chunk=16)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(st.numpy(), np.asarray(sr), rtol=2e-3,
                               atol=2e-3)


def test_bfloat16_x_rounds_only_the_output():
    """bf16 xh: the same float32 arithmetic on its values, y rounded to
    bf16 once at the end, as the Pallas kernel does."""
    import jax.numpy as jnp
    from repro.kernels.ssd_scan import ssd_scan as pallas
    arrays = _inputs(21, 2, 32, 4, 8, 16)
    arrays = (arrays[0].astype(np.float32),) + arrays[1:]
    xb = torch.from_numpy(arrays[0]).to(torch.bfloat16)
    y, st = K4.ssd_scan(xb, *_port(arrays)[1:], chunk=16)
    yr, sr = pallas(jnp.asarray(arrays[0], jnp.bfloat16),
                    *(jnp.asarray(a) for a in arrays[1:]), chunk=16,
                    head_tile=2, interpret=True)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(yr, np.float32),
                               rtol=2 ** -7, atol=1e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(sr), rtol=1e-4,
                               atol=1e-4)


def test_steep_decay_stays_finite():
    """dt * A of -60 per token: exp(cum[q] - cum[k]) above the diagonal
    would overflow float32; only k <= q is exponentiated."""
    B, S, nh, P, N = 1, 32, 2, 4, 8
    xh, Bm, Cm, dt, A = _inputs(31, B, S, nh, P, N)
    dt[:] = 3.0
    A[:] = -20.0
    y, st = K4.ssd_scan(*_port((xh, Bm, Cm, dt, A)), chunk=32)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    # then each step keeps only its own input: y_t = (C_t . B_t) dt_t x_t
    want = np.einsum("bshn,bshn->bsh", Cm, Bm)[..., None] * dt[..., None] \
        * xh
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["ragged", "groups", "dtype", "x_dtype",
                                  "contiguous", "smem", "wide_p", "odd_n"])
def test_wrapper_refuses_what_the_kernel_cannot_take(case):
    xh, Bm, Cm, dt, A = _port(_inputs(41, 1, 32, 4, 8, 16))
    chunk = 16
    if case == "ragged":
        chunk = 12
    elif case == "groups":
        Bm, Cm = Bm[:, :, :3].contiguous(), Cm[:, :, :3].contiguous()
    elif case == "dtype":
        dt = dt.double()
    elif case == "x_dtype":
        xh = xh.half()
    elif case == "contiguous":
        xh = xh.transpose(2, 3).contiguous().transpose(2, 3)
    elif case == "smem":
        xh, Bm, Cm, dt, A = _port(_inputs(42, 1, 256, 1, 64, 128))
        chunk = 256
    elif case == "wide_p":
        xh, Bm, Cm, dt, A = _port(_inputs(43, 1, 64, 2, 128, 64))
        chunk = 64
    else:
        xh, Bm, Cm, dt, A = _port(_inputs(44, 1, 32, 2, 8, 18))
    before = K4.ssd_scan.plain_calls
    with pytest.raises((ValueError, TypeError)):
        K4.ssd_scan(xh, Bm, Cm, dt, A, chunk=chunk)
    assert K4.ssd_scan.plain_calls == before


def test_smem_budget_fits_the_serving_shape():
    """One layout for every shape the tiles take, the serving shape's
    (chunk 128, P 64, N 128) included: two CTAs fit on an SM."""
    assert K4.smem_bytes() <= K4.SMEM_LIMIT
    assert 2 * (K4.smem_bytes() + K4.CTA_RESERVED) <= K4.SM_SMEM
    assert K4.smem_bytes() == 4 * (128 * 64 + 4 * 128 + 4 * 128 * 36)


def test_shared_memory_refusal():
    """A block with less shared memory than the kernel's layout is
    refused before any launch; the H100's opt-in limit is not."""
    K4.check_smem(K4.SMEM_LIMIT)
    with pytest.raises(ValueError, match="shared memory"):
        K4.check_smem(K4.smem_bytes() - 1)


def test_work_ids_run_chunk_slowest():
    """The kernel's work ids walk every (row, head) of one chunk before
    the next chunk, so the CTA holding id i waits only on the lower id
    i - B * nh: the same row and head, one chunk earlier."""
    Bsz, nh, nc = 2, 3, 4
    items = [K4.work_item(i, Bsz, nh) for i in range(Bsz * nh * nc)]
    assert items[:7] == [(0, 0, 0), (0, 1, 0), (0, 2, 0), (1, 0, 0),
                         (1, 1, 0), (1, 2, 0), (0, 0, 1)]
    assert sorted(items, key=lambda t: (t[2], t[0], t[1])) == items
    assert sorted(items) == [(b, h, c) for b in range(Bsz)
                             for h in range(nh) for c in range(nc)]
    for i, (b, h, c) in enumerate(items):
        if c:
            assert items[i - Bsz * nh] == (b, h, c - 1)


def test_scratch_buffers_grow_per_stream_and_keep_tickets_zero():
    """`build.scratch`, the K1/K4 wrappers' per-(device, stream) cache:
    reused while it fits, grown to the larger size, zeroed buffers at 0."""
    from repro_torch.kernels.build import scratch
    cache, dev = {}, torch.device("cpu")
    specs = ((10, torch.float32, False), (4, torch.int32, True))
    a = scratch(cache, dev, 7, specs)
    assert [t.numel() for t in a] == [10, 4] and not a[1].any()
    assert scratch(cache, dev, 7, ((6, torch.float32, False),
                                   (2, torch.int32, True))) is a
    b = scratch(cache, dev, 7, ((8, torch.float32, False),
                                (9, torch.int32, True)))
    assert [t.numel() for t in b] == [10, 9] and not b[1].any()
    assert scratch(cache, dev, 8, specs) is not b     # another stream
    assert len(cache) == 2


def test_scratch_is_one_slot_and_flag_per_row_and_head():
    # the serving shape: 4 x 64 slots of 64 x 128 floats (8 MB), 257 ints
    assert K4.scratch_sizes(4, 64, 64, 128) == (4 * 64 * 64 * 128, 257)
    assert K4.scratch_sizes(1, 8, 8, 16) == (1024, 9)


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,nh,P,N,G,chunk", [
    (4, 1024, 64, 64, 128, 1, 128), (2, 64, 4, 16, 16, 4, 16),
    (1, 96, 8, 8, 32, 2, 32), (2, 32, 16, 8, 16, 1, 16),
    # 16 chunks a chain; one chunk; few CTAs with long chains and groups
    (2, 2048, 16, 64, 128, 1, 128), (2, 128, 8, 64, 128, 1, 128),
    (1, 2048, 8, 64, 128, 2, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(cuda_device, B, S, nh, P, N, G, chunk,
                                      dtype):
    """Float32 arithmetic in both, summed in another order: y within
    1e-4 of the plain version's scale (bf16 y within one unit in the
    last place), the state within 1e-4 relative."""
    arrays = _inputs(B + S + nh, B, S, nh, P, N, G=G)
    args = [t.to(cuda_device) for t in _port(arrays, dtype)]
    launches = K4.ssd_scan.launches
    y, st = K4.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert K4.ssd_scan.launches == launches + 1
    yp, sp = K4.ssd_scan_plain(*args, chunk=chunk)
    scale = float(yp.float().abs().max())
    rtol = 2 ** -7 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(y.float(), yp.float(), rtol=rtol,
                               atol=1e-4 * scale)
    torch.testing.assert_close(st, sp, rtol=1e-4,
                               atol=1e-4 * float(sp.abs().max()))


@pytest.mark.cuda
def test_kernel_calls_in_a_row_agree_bitwise(cuda_device):
    """The work counter and the flags reset themselves: a second call on
    the same stream, and a third at another shape, repeat the first
    bitwise."""
    arrays = _inputs(5, 2, 512, 8, 64, 128, G=1)
    args = [t.to(cuda_device) for t in _port(arrays, torch.bfloat16)]
    y1, s1 = K4.ssd_scan(*args, chunk=128)
    small = [t.to(cuda_device) for t in _port(_inputs(6, 1, 64, 4, 16, 16))]
    K4.ssd_scan(*small, chunk=16)
    y2, s2 = K4.ssd_scan(*args, chunk=128)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(s1, s2)

"""The port's K2 lookup (`repro_torch.kernels.knn_topk`) against the
Pallas reference.

On the CPU the wrapper runs its plain version; it is held against
`repro.kernels.ops.knn_topk` (the Pallas kernel in interpret mode) on
the shapes of `tests/test_kernels.py::test_knn_topk`, with inputs drawn
from a seeded numpy generator (random normal, so no two distances tie).
Tolerances are the reference's own: d2 within rtol = atol = 3e-4 in
float32 and 3e-2 in bfloat16 (the norms are summed in bf16 by two
libraries), and idx identical in float32. The KNN estimator's three
backends are held against the reference's three as
`tests/test_kernels.py::test_knn_estimator_backend_parity` does: the
numpy copy bitwise, "torch" against "jax" and "kernel" against "pallas"
within rtol 1e-5, atol 1e-6 (their distances go through two libraries'
float32 matmuls).

The CUDA kernel is held against the plain version by the tests marked
`cuda`, which skip without a card.
"""
import numpy as np
import pytest
import torch

from repro_torch.estimators.knn import KNNEstimator
from repro_torch.kernels import knn_topk as K

SHAPES = [(4, 700, 32, 5, 128), (16, 2048, 128, 10, 512),
          (2, 100, 16, 3, 64), (8, 1024, 64, 10, 256)]


def _inputs(seed, B, N, E):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, E)).astype(np.float32),
            rng.normal(size=(N, E)).astype(np.float32))


@pytest.mark.parametrize("B,N,E,k,tile", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_reference(B, N, E, k, tile, dtype):
    import jax.numpy as jnp      # here: the card's machine has no jax
    from repro.kernels.ops import knn_topk as ref_knn_topk
    q, x = _inputs(B * N, B, N, E)
    rd, ri = ref_knn_topk(jnp.asarray(q, dtype), jnp.asarray(x, dtype), k=k,
                          tile=tile)
    tdt = getattr(torch, dtype)
    d, i = K.knn_topk(torch.from_numpy(q).to(tdt),
                      torch.from_numpy(x).to(tdt), k)
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    assert tuple(d.shape) == tuple(i.shape) == (B, k)
    tol = 3e-2 if dtype == "bfloat16" else 3e-4
    np.testing.assert_allclose(d.numpy(), np.asarray(rd), rtol=tol, atol=tol)
    if dtype == "float32":
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))


def test_plain_orders_ties_by_index():
    """On dyadic inputs many distances tie exactly; the plain version
    keeps (distance, index) order, the contract the kernel shares."""
    rng = np.random.default_rng(3)
    q = (rng.integers(-2, 3, (6, 8)) / 2).astype(np.float32)
    x = (rng.integers(-2, 3, (300, 8)) / 2).astype(np.float32)
    d, i = K.knn_topk(torch.from_numpy(q), torch.from_numpy(x), 12)
    full = ((q * q).sum(1)[:, None] + (x * x).sum(1)[None, :]) - 2 * q @ x.T
    want = np.argsort(full, axis=1, kind="stable")[:, :12]
    np.testing.assert_array_equal(i.numpy(), want)
    np.testing.assert_array_equal(
        d.numpy(), np.take_along_axis(full, want, 1).astype(np.float32))


def test_precomputed_xsq_is_the_same_function():
    q, x = _inputs(5, 4, 300, 16)
    qt, xt = torch.from_numpy(q), torch.from_numpy(x)
    a = K.knn_topk(qt, xt, 7)
    b = K.knn_topk(qt, xt, 7, xsq=(xt * xt).sum(1))
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_estimator_backends_match_reference():
    from repro.estimators.knn import KNNEstimator as RefKNN
    rng = np.random.default_rng(0)
    x = rng.normal(size=(500, 32)).astype(np.float32)
    ql = rng.uniform(size=(500, 4)).astype(np.float32)
    ln = rng.uniform(50, 500, (500, 4)).astype(np.float32)
    q = rng.normal(size=(8, 32)).astype(np.float32)
    for port, ref in (("numpy", "numpy"), ("torch", "jax"),
                      ("kernel", "pallas")):
        want = RefKNN(k=7, backend=ref).fit(x, ql, ln).query(q)
        got = KNNEstimator(k=7, backend=port, device="cpu").fit(
            x, ql, ln).query(q)
        for g, w in zip(got, want):
            assert g.dtype == np.float32 and g.shape == w.shape
            if port == "numpy":
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_estimator_copies_share_the_index():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    labels = (rng.uniform(size=(64, 2)), rng.uniform(20, 90, (64, 2)))
    knn = KNNEstimator(k=3, device="cpu").fit(x, *labels)
    other = knn.with_backend("kernel")
    assert knn.backend == "torch" and other.backend == "kernel"
    assert other._x is knn._x
    q = x[:5] + 0.01
    fresh = KNNEstimator(k=3, backend="kernel", device="cpu").fit(x, *labels)
    for a, b in zip(other.query(q), fresh.query(q)):
        np.testing.assert_array_equal(a, b)
    assert 0.0 <= knn.best_model_accuracy(q, rng.uniform(size=(5, 2))) <= 1.0
    with pytest.raises(ValueError, match="'kernel'"):
        knn.with_backend("pallas")


def test_cpu_tensors_count_plain_calls_not_launches():
    q, x = _inputs(2, 3, 40, 8)
    before = (K.knn_topk.launches, K.knn_topk.plain_calls)
    K.knn_topk(torch.from_numpy(q), torch.from_numpy(x), 4)
    assert K.knn_topk.launches == before[0]
    assert K.knn_topk.plain_calls == before[1] + 1


@pytest.mark.parametrize("case", ["k_over_32", "k_over_n", "dtype",
                                  "misaligned", "shape"])
def test_wrapper_refuses_what_the_kernel_cannot_take(case):
    q, x = _inputs(4, 3, 40, 8)
    qt, xt, k = torch.from_numpy(q), torch.from_numpy(x), 4
    if case == "k_over_32":
        xt, k = torch.from_numpy(_inputs(4, 3, 64, 8)[1]), 33
    elif case == "k_over_n":
        k = 41
    elif case == "dtype":
        qt, xt = qt.double(), xt.double()
    elif case == "misaligned":
        xt = torch.from_numpy(np.concatenate([[0.0], x.ravel()]).astype(
            np.float32))[1:].view(40, 8)          # 4 bytes off 16
    else:
        qt = qt[:, :4].contiguous()
    before = K.knn_topk.plain_calls
    with pytest.raises((ValueError, TypeError)):
        K.knn_topk(qt, xt, k)
    assert K.knn_topk.plain_calls == before


def test_build_hash_covers_shared_headers(tmp_path, monkeypatch):
    """An edit to a header the kernels share must rebuild them."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "a.cu").write_text('#include "common.cuh"\n')
    header = tmp_path / "common.cuh"
    header.write_text("// v1\n")
    before = build._tree_hash()
    header.write_text("// v2\n")
    assert build._tree_hash() != before
    assert [p.name for p in build._sources()] == ["a.cu"]


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,k", [(1, 14886, 10), (8, 14886, 10),
                                   (64, 14886, 10), (256, 14886, 10),
                                   (8, 1000, 32), (5, 37, 7)])
def test_kernel_matches_plain_on_card_dyadic(cuda_device, B, N, k):
    """Dyadic inputs (multiples of 1/8): every distance is exact in
    float32 and ties are common, so d2 and idx must be identical."""
    rng = np.random.default_rng(B + N + k)
    q = torch.tensor(rng.integers(-8, 9, (B, 128)) / 8, dtype=torch.float32,
                     device=cuda_device)
    x = torch.tensor(rng.integers(-8, 9, (N, 128)) / 8, dtype=torch.float32,
                     device=cuda_device)
    launches = K.knn_topk.launches
    d, i = K.knn_topk(q, x, k)
    torch.cuda.synchronize()
    assert K.knn_topk.launches == launches + 1
    pd, pi = K.knn_topk_plain(q, x, k)
    assert torch.equal(i, pi) and torch.equal(d, pd)
    assert int(i.max()) < N


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card_normal(cuda_device, dtype):
    """Random normal inputs: idx on >= 99% of rows, d2 within rtol 1e-5
    (the dot products are summed in another order)."""
    rng = np.random.default_rng(9)
    q = torch.tensor(rng.normal(size=(64, 128)), device=cuda_device).to(dtype)
    x = torch.tensor(rng.normal(size=(14886, 128)),
                     device=cuda_device).to(dtype)
    d, i = K.knn_topk(q, x, 10)
    pd, pi = K.knn_topk_plain(q, x, 10)
    assert (i == pi).all(1).float().mean().item() >= 0.99
    torch.testing.assert_close(d, pd, rtol=1e-5, atol=0.0)

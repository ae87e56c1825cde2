"""The port's estimator stack and tiers against the JAX reference.

The encoder gets the reference's weights through
`repro_torch.estimators.bridge.bundle_from_arrays` (numpy only) and must
give the reference's embeddings within rtol 1e-5, atol 1e-6 (float32
matmuls, softmax and tanh are summed and rounded differently by the two
libraries). The KNN lookup over the same index agrees within rtol 1e-5,
atol 1e-6 (its distances go through a float32 matmul). The packed GBM
TPOT heads are bitwise the numpy ensemble, and the numpy fit itself is
a copy, so the port trains the reference's trees exactly. The tiers of
the simulated pool carry the reference's roofline numbers exactly.
"""
import jax
import numpy as np
import pytest
import torch

from repro_torch.estimators.bridge import bundle_from_arrays
from repro_torch.estimators.gbm import pack_ensemble, predict_packed_gathered


def _arrays(bundle, tiers):
    heads = [{"name": t.name,
              "nominal_tpot": bundle.heads[t.name].nominal_tpot,
              "packed": bundle.heads[t.name].model.pack()} for t in tiers]
    params = jax.tree_util.tree_map(np.asarray, bundle.encoder.params)
    return (params, bundle.knn._x, bundle.knn._quality, bundle.knn._length,
            heads)


@pytest.fixture(scope="module")
def bridged(small_ctx):
    params, x, q, ln, heads = _arrays(small_ctx["bundle"], small_ctx["tiers"])
    return bundle_from_arrays(params, x, q, ln, heads, small_ctx["names"],
                              device="cpu")


def test_encoder_matches_reference(small_ctx, bridged):
    from repro.estimators.embedding import pad_tokens
    prompts, _, _ = small_ctx["ds"].split("test")
    enc = small_ctx["bundle"].encoder
    toks = pad_tokens([p.tokens for p in prompts[:48]], enc.max_len)
    lens = np.array([min(len(p.tokens), enc.max_len) for p in prompts[:48]])
    want = enc.encode(toks, lens)
    got = bridged.encoder.encode(toks, lens)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_knn_query_matches_reference(small_ctx, bridged):
    from repro.estimators.knn import KNNEstimator
    ref = small_ctx["bundle"].knn
    jax_knn = KNNEstimator(k=ref.k, backend="jax").fit(
        ref._x, ref._quality, ref._length)
    rng = np.random.default_rng(0)
    q = ref._x[rng.integers(0, len(ref._x), 24)] + rng.normal(
        0, 0.05, (24, ref._x.shape[1])).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    want_q, want_l = jax_knn.query(q)
    got_q, got_l = bridged.knn.query(q)
    np.testing.assert_allclose(got_q, want_q, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(bridged.knn._sq, ref._sq)


def test_gbm_heads_bitwise_numpy_predict(small_ctx, bridged):
    """Bridged heads: the port's packed torch inference and its numpy
    predict both equal the reference booster's numpy predict bit for
    bit, per tier and gathered across tiers."""
    rng = np.random.default_rng(1)
    X = np.stack([rng.integers(1, 48, 64), rng.uniform(0, 3000, 64),
                  rng.uniform(64, 2048, 64)], 1).astype(np.float32)
    X = np.concatenate([X, (X[:, 0] * X[:, 2])[:, None]], 1)
    names = [t.name for t in small_ctx["tiers"]]
    ref_heads = [small_ctx["bundle"].heads[n] for n in names]
    port_heads = [bridged.heads[n] for n in names]
    st = pack_ensemble([h.model for h in port_heads])
    stacked = {k: (torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray)
                   else v) for k, v in st.items()}
    member = rng.integers(0, len(names), 64)
    got = predict_packed_gathered(stacked, torch.from_numpy(member),
                                  torch.from_numpy(X)).numpy()
    want = np.array([ref_heads[m].model.predict(X[i:i + 1])[0]
                     for i, m in enumerate(member)], np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    for rh, ph in zip(ref_heads, port_heads):
        np.testing.assert_array_equal(ph.tpot_batch(X), rh.tpot_batch(X))
        assert ph.nominal_tpot == rh.nominal_tpot


def test_port_trains_the_reference_heads(small_ctx):
    """The port's own `EstimatorBundle.train` (on the CPU here) fits the
    reference's TPOT trees exactly: same sweep, same numpy fit."""
    from repro_torch.core import EstimatorBundle
    from repro_torch.serving.tiers import paper_pool_tiers
    from repro_torch.serving.world import build_dataset, paper_world
    world, names = paper_world(seed=0)
    ds = build_dataset(world, n=400)
    bundle = EstimatorBundle.train(ds, paper_pool_tiers(), names,
                                   device="cpu")
    assert bundle.device.type == "cpu" and names == small_ctx["names"]
    for t in small_ctx["tiers"]:
        got = bundle.heads[t.name].model.pack()
        want = small_ctx["bundle"].heads[t.name].model.pack()
        for k in ("feature", "threshold", "leaf"):
            np.testing.assert_array_equal(got[k], want[k])
        assert (got["base"], got["lr"], got["depth"]) == (
            want["base"], want["lr"], want["depth"])
    # the KNN labels are the reference's; the embeddings are the port's
    # own encoder's (torch.Generator weights), unit-norm like the reference
    np.testing.assert_array_equal(bundle.knn._quality,
                                  small_ctx["bundle"].knn._quality)
    np.testing.assert_allclose(np.linalg.norm(bundle.knn._x, axis=1), 1.0,
                               rtol=1e-5)


def test_tiers_match_reference(small_ctx):
    from repro_torch.serving.tiers import paper_pool_tiers
    for p, r in zip(paper_pool_tiers(), small_ctx["tiers"], strict=True):
        assert (p.name, p.model, p.n_chips, p.n_instances, p.price_in,
                p.price_out, p.max_batch) == (
            r.name, r.model, r.n_chips, r.n_instances, r.price_in,
            r.price_out, r.max_batch)
        assert p.n_params == r.n_params
        assert p.kv_bytes_per_token == r.kv_bytes_per_token
        for b, ctx in ((1, 64.0), (8, 500.0), (48, 2048.0)):
            assert p.tpot(b, ctx) == r.tpot(b, ctx)
        assert p.prefill_time(300.0) == r.prefill_time(300.0)


def test_world_and_arrivals_match_reference(small_ctx):
    from repro.serving.workload import poisson_arrivals as r_arr
    from repro_torch.serving.workload import poisson_arrivals as p_arr
    from repro_torch.serving.world import build_dataset, paper_world
    world, names = paper_world(seed=0)
    ds = build_dataset(world, n=400)
    ref = small_ctx["ds"]
    np.testing.assert_array_equal(ds.quality, ref.quality)
    np.testing.assert_array_equal(ds.lengths, ref.lengths)
    np.testing.assert_array_equal(ds.test_idx, ref.test_idx)
    for a, b in zip(ds.prompts, ref.prompts, strict=True):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert a.len_in == b.len_in
    np.testing.assert_array_equal(p_arr(12.0, 50, seed=3),
                                  r_arr(12.0, 50, seed=3))


@pytest.mark.parametrize("leaves", [False, True], ids=["values", "leaves"])
@pytest.mark.parametrize("seed,n_trees,depth", [(1, 15, 3), (4, 60, 4)])
def test_predict_packed_bitwise(seed, n_trees, depth, leaves):
    """`predict_packed` (every tree against every row) is bitwise the
    reference's jnp `predict_packed` and the numpy booster's `predict`,
    and with `return_leaves` gives the reference's (T, n) leaf indices;
    on numpy input without a card it refuses to choose the CPU."""
    import jax.numpy as jnp
    from repro.estimators.gbm import GradientBoostedRegressor as RefGBM
    from repro.estimators.gbm import predict_packed as ref_predict
    from repro_torch.estimators.gbm import GradientBoostedRegressor, \
        predict_packed
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(400, 4)).astype(np.float32)
    y = (X[:, 0] - 0.5 * X[:, 2] ** 2).astype(np.float32)
    ref = RefGBM(n_trees=n_trees, depth=depth).fit(X, y)
    g = GradientBoostedRegressor.from_packed(ref.pack())
    Xq = rng.normal(size=(97, 4)).astype(np.float32)
    got = predict_packed(g.pack(), torch.from_numpy(Xq),
                         return_leaves=leaves)
    want = ref_predict(ref.pack(), jnp.asarray(Xq), return_leaves=leaves)
    if leaves:
        (got, got_idx), (want, want_idx) = got, want
        assert got_idx.dtype == torch.int32
        assert np.array_equal(got_idx.numpy(), np.asarray(want_idx))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), ref.predict(Xq))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            predict_packed(g.pack(), Xq)

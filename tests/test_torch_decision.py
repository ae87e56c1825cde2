"""The port's decision math against the JAX reference, bit for bit.

Every helper of the decision (`repro_torch.core.scoring/budget/decision`,
`estimators.knn.distance_weights`, `estimators.gbm`, `serving.affinity.
hit_fraction`) gets the same float32 inputs, made with numpy from a
seed, as its reference in `repro`; the outputs must be bitwise equal.
The references run as eager jnp (one XLA op at a time, the arithmetic
the port spells out) and, where they are numpy-typed, as numpy float32.
The greedy scan is held against the reference's `lax.scan`
(`decision_jax._greedy_scan`) across the four latency modes, with pad
rows, dead columns and the affinity term.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import budget as r_budget
from repro.core import decision_jax as r_dec
from repro.core import scoring as r_scoring
from repro.estimators import gbm as r_gbm
from repro.estimators import knn as r_knn
from repro.serving import affinity as r_aff
from repro_torch.core import budget as p_budget
from repro_torch.core import decision as p_dec
from repro_torch.core import scoring as p_scoring
from repro_torch.estimators import gbm as p_gbm
from repro_torch.estimators import knn as p_knn
from repro_torch.serving import affinity as p_aff

MODES = ("full", "off_reactive", "off_predictive", "static_prior")
f32 = np.float32


def T(a):
    return torch.from_numpy(np.array(a))


def same(got, want):
    """Bitwise equality (NaN == NaN, -0.0 != +0.0 only via the bits)."""
    g = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got)
    w = np.asarray(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    if g.dtype == np.bool_ or np.issubdtype(g.dtype, np.integer):
        np.testing.assert_array_equal(g, w.astype(g.dtype))
    else:
        np.testing.assert_array_equal(g.view(np.uint32),
                                      w.astype(f32).view(np.uint32))


def _plane(rng, R=12, I=9, masked=True):
    q = rng.uniform(0, 1, (R, I)).astype(f32)
    c = rng.uniform(1e-6, 1e-3, (R, I)).astype(f32)
    t = rng.uniform(0.1, 20, (R, I)).astype(f32)
    mask = rng.uniform(size=(R, I)) < (0.7 if masked else 1.1)
    mask[np.arange(R), rng.integers(0, I, R)] = True   # >= 1 allowed
    return q, c, t, mask


@pytest.mark.parametrize("seed", range(3))
def test_quantize_scores_bitwise_half_quantum_ties(seed):
    rng = np.random.default_rng(seed)
    s = rng.uniform(-2, 2, 500).astype(f32)
    # exact half-quantum points: round half to even in all three
    k = rng.integers(-8000, 8000, 200)
    s = np.concatenate([s, ((k + 0.5) * 2.0 ** -13).astype(f32),
                        np.array([-np.inf], f32)])
    got = p_scoring.quantize_scores(T(s))
    same(got, r_scoring.quantize_scores(s, np))
    same(got, np.asarray(r_scoring.quantize_scores(jnp.asarray(s), jnp)))


@pytest.mark.parametrize("weights", [(1 / 3, 1 / 3, 1 / 3), (0.8, 0.1, 0.1),
                                     (0.2, 0.0, 0.8)])
@pytest.mark.parametrize("seed", range(2))
def test_masked_score_bitwise(seed, weights):
    rng = np.random.default_rng(seed)
    q, c, t, mask = _plane(rng)
    got = p_scoring.masked_score(T(q), T(c), T(t), weights, T(mask))
    same(got, r_scoring.masked_score(q, c, t, weights, mask, np))
    same(got, np.asarray(r_scoring.masked_score(
        jnp.asarray(q), jnp.asarray(c), jnp.asarray(t), weights,
        jnp.asarray(mask), jnp)))
    assert torch.isinf(got[~T(mask)]).all()


def test_affinity_discount_bitwise():
    rng = np.random.default_rng(0)
    t = rng.uniform(0.1, 20, (6, 7)).astype(f32)
    a = (0.35 * rng.uniform(0, 1, (6, 7))).astype(f32)
    a[0] = 0.0
    got = p_scoring.affinity_discount(T(t), T(a))
    same(got, np.asarray(r_scoring.affinity_discount(
        jnp.asarray(t), jnp.asarray(a), jnp)))
    same(got[0], t[0])                     # weight 0 is an IEEE identity


@pytest.mark.parametrize("seed", range(3))
def test_cost_and_admission_bitwise(seed):
    rng = np.random.default_rng(seed)
    R, I = 16, 11
    len_in = rng.integers(8, 400, R).astype(f32)
    pred = rng.uniform(20, 600, (R, I)).astype(f32)
    pin = rng.uniform(0.05, 0.4, I).astype(f32)
    pout = rng.uniform(0.05, 0.4, I).astype(f32)
    pin[3], pout[3] = pin[2], pout[2]      # cost ties: first index wins
    pred[:, 3] = pred[:, 2]
    budgets = np.where(rng.uniform(size=R) < 0.5,
                       rng.uniform(1e-6, 2e-4, R), np.nan).astype(f32)
    budgets[0] = 1e-12                     # nothing fits: cheapest
    valid = rng.uniform(size=I) < 0.8
    valid[2] = False                       # a dead column in the tie
    got_c = p_budget.cost_matrix(T(len_in), T(pred), T(pin), T(pout))
    same(got_c, r_budget.cost_matrix(len_in, pred, pin, pout, np))
    for v in (None, valid):
        al, ch = p_budget.admission_math(
            T(budgets), T(len_in), T(pred), T(pin), T(pout),
            valid=None if v is None else T(v))
        ral, rch = r_budget.admission_math(
            jnp.asarray(budgets), jnp.asarray(len_in), jnp.asarray(pred),
            jnp.asarray(pin), jnp.asarray(pout), jnp,
            valid=None if v is None else jnp.asarray(v))
        same(al, np.asarray(ral))
        same(ch, np.asarray(rch))
    assert al[0].sum() == 1 and not al[0, 2]


@pytest.mark.parametrize("seed", range(3))
def test_distance_weights_bitwise(seed):
    rng = np.random.default_rng(seed)
    d2 = rng.uniform(-1e-3, 3, (20, 10)).astype(f32)    # negatives clamp
    d2[0, :3] = 0.0
    got = p_knn.distance_weights(T(d2), 1e-6)
    same(got, np.asarray(r_knn.distance_weights(jnp.asarray(d2), 1e-6,
                                                jnp)))


def _boosters(seed, n=3, trees=7, depth=3):
    rng = np.random.default_rng(seed)
    models = []
    for _ in range(n):
        X = rng.uniform(0, 900, (300, 4)).astype(f32)
        y = (0.02 + 1e-5 * X[:, 1] + 1e-4 * X[:, 0]
             + rng.normal(0, 1e-3, 300)).astype(f32)
        models.append(r_gbm.GradientBoostedRegressor(
            n_trees=trees, depth=depth).fit(X, y))
    return models, rng


def test_accumulate_bitwise():
    rng = np.random.default_rng(0)
    vals = rng.normal(0, 0.01, (5, 60, 13)).astype(f32)
    base = rng.uniform(0, 0.05, 13).astype(f32)
    got = p_gbm._accumulate(T(base), 0.15, T(vals))
    same(got, r_gbm._accumulate(base, 0.15, vals, np))
    same(got, np.asarray(r_gbm._accumulate(jnp.asarray(base), 0.15,
                                           jnp.asarray(vals), jnp)))


@pytest.mark.parametrize("seed", range(2))
def test_predict_packed_gathered_bitwise(seed):
    models, rng = _boosters(seed)
    stacked = r_gbm.pack_ensemble(models)
    member = rng.integers(0, len(models), 40).astype(np.int32)
    X = rng.uniform(0, 900, (40, 4)).astype(f32)
    p_stacked = {k: (T(v) if isinstance(v, np.ndarray) else v)
                 for k, v in stacked.items()}
    got = p_gbm.predict_packed_gathered(p_stacked, T(member).long(), T(X))
    same(got, np.asarray(r_gbm.predict_packed_gathered(
        stacked, jnp.asarray(member), jnp.asarray(X))))
    # and the numpy ensemble loop, row by row
    want = np.array([models[m].predict(X[i:i + 1])[0]
                     for i, m in enumerate(member)], f32)
    same(got, want)


def _sigs(rng, R, I, W=8, S=64):
    pool = rng.integers(1, 2 ** 31 - 1, 40).astype(np.int32)
    req = pool[rng.integers(0, len(pool), (R, W))]
    req[rng.uniform(size=(R, W)) < 0.2] = 0            # absent columns
    plane = pool[rng.integers(0, len(pool), (I, S))]
    plane[rng.uniform(size=(I, S)) < 0.5] = 0          # empty slots
    return req, plane


@pytest.mark.parametrize("seed", range(3))
def test_hit_fraction_bitwise(seed):
    rng = np.random.default_rng(seed)
    req, plane = _sigs(rng, 10, 7)
    len_in = rng.integers(0, 200, 10).astype(f32)
    got = p_aff.hit_fraction(T(req), T(len_in), T(plane))
    same(got, r_aff.hit_fraction(req, len_in, plane, np))
    same(got, np.asarray(r_aff.hit_fraction(
        jnp.asarray(req), jnp.asarray(len_in), jnp.asarray(plane), jnp)))
    assert (got > 0).any()


def _scan_inputs(seed, R=16, I=16, aff=False):
    rng = np.random.default_rng(seed)
    q, c, _, _ = _plane(rng, R, I)
    l_inst = rng.uniform(20, 600, (R, I)).astype(f32)
    tpot = rng.uniform(0.005, 0.05, I).astype(f32)
    nominal = rng.uniform(0.005, 0.05, I).astype(f32)
    d = rng.uniform(0, 3000, I).astype(f32)
    b = rng.integers(1, 40, I).astype(f32)
    free = rng.integers(0, 4, I).astype(f32)
    maxb = np.full(I, 48.0, f32)
    maxb[:3] = b[:3] + 1                    # batches that saturate
    alive = np.ones(I, bool)
    alive[I - 3:] = False                   # dead and pad columns
    budgets = np.where(rng.uniform(size=R) < 0.5,
                       rng.uniform(1e-6, 2e-4, R), np.nan).astype(f32)
    len_in = rng.integers(8, 400, R).astype(f32)
    pin = rng.uniform(0.05, 0.4, I).astype(f32)
    pout = rng.uniform(0.05, 0.4, I).astype(f32)
    rv = np.ones(R, bool)
    rv[R - 4:] = False                      # pad rows
    key = np.where(rv, l_inst.max(1), -1e30).astype(f32)
    order = np.argsort(-key, kind="stable").astype(np.int64)
    affinity = None
    if aff:
        req, plane = _sigs(rng, R, I)
        hit = r_aff.hit_fraction(req, len_in, plane, np)
        affinity = (f32(0.35) * np.where(alive[None, :], hit, f32(0))
                    ).astype(f32)
    return dict(order=order, q=q, l_inst=l_inst, tpot=tpot,
                nominal=nominal, d=d, b=b, free=free, maxb=maxb,
                alive=alive, budgets=budgets, len_in=len_in, pin=pin,
                pout=pout, rv=rv, affinity=affinity)


@pytest.mark.parametrize("aff", [False, True], ids=["noaff", "aff"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", range(2))
def test_greedy_scan_bitwise(seed, mode, aff):
    """choice, est_T and the post-scan (d, b, free) carry equal the
    reference's lax.scan bit for bit, with pad rows that apply no update
    and dead columns that never admit."""
    a = _scan_inputs(seed, aff=aff)
    weights = (1 / 3, 1 / 3, 1 / 3)
    allowed, c_hat = r_budget.admission_math(
        jnp.asarray(a["budgets"]), jnp.asarray(a["len_in"]),
        jnp.asarray(a["l_inst"]), jnp.asarray(a["pin"]),
        jnp.asarray(a["pout"]), jnp, valid=jnp.asarray(a["alive"]))
    allowed, c_hat = np.asarray(allowed), np.asarray(c_hat)
    ch, est, (d1, b1, f1) = r_dec._greedy_scan(
        jnp.asarray(a["order"]), jnp.asarray(a["q"]), jnp.asarray(c_hat),
        jnp.asarray(a["l_inst"]), jnp.asarray(a["tpot"]),
        jnp.asarray(a["nominal"]), jnp.asarray(a["d"]),
        jnp.asarray(a["b"]), jnp.asarray(a["free"]),
        jnp.asarray(a["maxb"]), weights, jnp.asarray(allowed), mode,
        row_valid=jnp.asarray(a["rv"]),
        affinity=None if a["affinity"] is None
        else jnp.asarray(a["affinity"]))
    gch, gest, (gd, gb, gf) = p_dec.greedy_scan(
        T(a["order"]), T(a["q"]), T(c_hat), T(a["l_inst"]), T(a["tpot"]),
        T(a["nominal"]), T(a["d"]), T(a["b"]), T(a["free"]), T(a["maxb"]),
        weights, T(allowed), mode, row_valid=T(a["rv"]),
        affinity=None if a["affinity"] is None else T(a["affinity"]))
    same(gch, np.asarray(ch))
    same(gest, np.asarray(est))
    for g, w in ((gd, d1), (gb, b1), (gf, f1)):
        same(g, np.asarray(w))
    assert a["alive"][gch.numpy()].all()    # dead columns never win


def test_bucket_pow2_matches_reference():
    for n in (0, 1, 7, 8, 9, 100, 1000):
        assert p_dec.bucket_pow2(n) == r_dec.bucket_pow2(n)
        assert p_dec.bucket_pow2(n, lo=1) == r_dec.bucket_pow2(n, lo=1)

"""The port's zero-allocation host path against the JAX reference: the
staging double buffer, the AoS fallback after a re-attach and the
ephemeral columns of a mixed batch (`repro_torch.core.hotpath`
`_stage_buffers`, `core.engine` lines 249-340, `serving.request.
RequestColumns.for_batch`).

Each case runs the reference's `tests/test_ingest.py` case on the
reference's `small_ctx` world and its counterpart on the port (bundle
bridged from the reference's weights, the port's megakernel backend:
the decision kernel's plain version on the CPU), on the same requests,
telemetry and embeddings. Choices must be identical to the reference's;
`l_chosen` within rtol 1e-5, as the kernel tests hold it.
"""
import numpy as np
import pytest

import repro_torch.core as P
from torch_scenario_parity import port_bundle


@pytest.fixture(scope="module")
def port(small_ctx):
    from repro_torch.serving.tiers import paper_pool_tiers
    from repro_torch.serving.world import build_dataset, paper_world
    world, names = paper_world(seed=0)
    return dict(bundle=port_bundle(small_ctx["bundle"], small_ctx["tiers"],
                                   small_ctx["names"]),
                ds=build_dataset(world, n=400), tiers=paper_pool_tiers(),
                names=names)


def _loaded_sims(small_ctx, port, seed=9):
    """The same randomized telemetry in both packages' sims."""
    from repro.serving.cluster import ClusterSim as RSim
    from repro.serving.scenarios import randomize_telemetry as r_rand
    from repro_torch.serving.cluster import ClusterSim
    from repro_torch.serving.scenarios import randomize_telemetry
    return (r_rand(RSim(small_ctx["tiers"], small_ctx["names"], seed=0),
                   seed, 0.0),
            randomize_telemetry(ClusterSim(port["tiers"], port["names"],
                                           seed=0), seed, 0.0))


def _batches(small_ctx, port, R, seed=5, with_budgets=True):
    """`tests/test_ingest.py::_batch` in both packages: R requests of one
    stream each, the same budgets, the port's stream holding the
    reference's ingest embeddings."""
    from repro.core import make_requests as r_make
    out = []
    for make, ds in ((r_make, small_ctx["ds"]), (P.make_requests,
                                                  port["ds"])):
        reqs = make(ds, "test", np.zeros(R))
        if with_budgets:
            rng = np.random.default_rng(seed)
            budgets = np.where(rng.uniform(size=R) < 0.5,
                               rng.uniform(1e-5, 3e-4, R), np.nan)
            for r, b in zip(reqs, budgets):
                r.budget = None if np.isnan(b) else float(b)
        out.append(reqs)
    rreqs, preqs = out
    rreqs[0].cols.ensure_embeddings(small_ctx["bundle"].encoder)
    preqs[0].cols.emb = np.asarray(rreqs[0].cols.emb)
    return rreqs, preqs


def _runners(small_ctx, port, rsim, psim):
    """A FusedHotPath in each package, built directly (not through a
    policy)."""
    from repro.core import RBConfig
    from repro.core.hotpath import FusedHotPath as RHot
    from repro_torch.core.hotpath import FusedHotPath
    return (RHot(small_ctx["bundle"], rsim.instances,
                 RBConfig(decision_backend="fused")),
            FusedHotPath(port["bundle"], psim.instances, P.RBConfig()))


def _same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=0)


def test_staging_double_buffer_no_alias(small_ctx, port):
    """Batches A, B (both in the 16 bucket: the staging set flips) and C
    (the 8 bucket) dispatched before any fetch: every fetched result is
    an independent eager decide's and the reference's, and the first
    call reseeds while the rest carry."""
    from repro.serving.request import batch_columns as r_cols
    from repro_torch.serving.request import batch_columns
    rsim, psim = _loaded_sims(small_ctx, port)
    rfp, fp = _runners(small_ctx, port, rsim, psim)
    _, eager = _runners(small_ctx, port, rsim, psim)
    pairs = [_batches(small_ctx, port, R, seed=R) for R in (13, 10, 5)]
    lazies, rlazies = [], []
    for rb, pb in pairs:                   # dispatch all, fetch nothing
        cols, rows = r_cols(rb)
        rlazies.append(rfp.decide_cols(cols, rows, rsim.tel))
        cols, rows = batch_columns(pb)
        lazies.append(fp.decide_cols(cols, rows, psim.tel))
    assert fp.stats["full_reseed"] == 1 and fp.stats["carry"] == 2
    assert fp.stats["full_reseed"] == rfp.stats["full_reseed"]
    assert fp.stats["carry"] == rfp.stats["carry"]
    for (rb, pb), lz, rlz in zip(pairs, lazies, rlazies):
        got = lz.fetch()
        for g, w in zip(got, eager.decide(pb, psim.tel)):
            np.testing.assert_array_equal(g, w)
        _same(got, rlz.fetch())
    again = lazies[0].fetch()               # fetch is idempotent
    np.testing.assert_array_equal(again[0], eager.decide(pairs[0][1],
                                                         psim.tel)[0])


def test_reattach_with_queued_requests_falls_back_to_aos(small_ctx, port):
    """Requests queued before a re-attach have no rows in the cleared
    ring: the engine marshals them AoS, and the decision is still the
    reference's."""
    from repro.core import RBConfig, RouteBalance
    rsim1, psim1 = _loaded_sims(small_ctx, port, seed=1)
    rsim2, psim2 = _loaded_sims(small_ctx, port, seed=2)
    rreqs, preqs = _batches(small_ctx, port, 4, with_budgets=False)
    got = []
    for rb, sims, reqs in (
            (RouteBalance(RBConfig(), small_ctx["bundle"],
                          small_ctx["tiers"]), (rsim1, rsim2), rreqs),
            (P.RouteBalance(P.RBConfig(), port["bundle"], port["tiers"]),
             (psim1, psim2), preqs)):
        rb.attach(sims[0])
        for r in reqs:
            rb.enqueue(r, 0.0)
        assert rb._wait_cols is reqs[0].cols
        rb.attach(sims[1])                  # waiting is non-empty
        assert rb._wait_cols is False
        instances, choice, l_chosen = rb._decide_core(reqs)
        assert len(choice) == len(reqs)
        got.append(([instances[int(c)].iid for c in choice], l_chosen))
    assert got[1][0] == got[0][0]
    np.testing.assert_allclose(got[1][1], got[0][1], rtol=1e-5, atol=0)


def test_ephemeral_columns_do_not_restamp_stream_requests(small_ctx, port):
    """A mixed batch (stream requests and a columnless one) builds
    ephemeral columns without restamping the stream requests: their
    budget still writes through to the stream's column, and the choices
    are the reference's."""
    rsim, psim = _loaded_sims(small_ctx, port)
    rfp, fp = _runners(small_ctx, port, rsim, psim)
    rstream, stream = _batches(small_ctx, port, 6, with_budgets=False)
    rloner, loner = (b[0] for b in _batches(small_ctx, port, 1,
                                            with_budgets=False))
    for r in (rloner, loner):
        r.cols, r.row = None, -1
    scols = stream[0].cols
    got = fp.decide(stream[:3] + [loner], psim.tel)
    assert len(got[0]) == 4
    assert all(r.cols is scols and r.row == i for i, r in enumerate(stream))
    stream[1].budget = 3e-4                  # write-through intact
    assert scols.budget[1] == 3e-4
    _same(got, rfp.decide(rstream[:3] + [rloner], rsim.tel))

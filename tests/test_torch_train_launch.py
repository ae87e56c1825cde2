"""The port's train step, train loop and launchers on the CPU.

  * `make_train_step` with 1 and 2 microbatches, with and without int8
    compression, against the reference's jitted step on the same
    weights (bridged) and batch: tolerances as in
    `tests/test_torch_training.py`, 1e-6 for the loss and lr, 1e-5 of
    each leaf's scale for the parameters after the step;
  * `train`: the loss falls (the reference's `test_loss_decreases`), with
    compression too, and a run cut at step 15 with a checkpoint every 10
    steps, resumed to step 25, repeats the uncut run's losses and
    parameters bitwise;
  * `python -m repro_torch.launch.train --smoke --device cpu` and
    `examples/torch_train_small.py --device cpu` run; without a card and
    without `--device cpu` the launcher raises the CUDA `RuntimeError`.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config, smoke_variant
from repro_torch.launch import train as launcher
from repro_torch.launch.steps import init_opt_state, make_train_step
from repro_torch.models import Model
from repro_torch.models.bridge import params_from_jax
from repro_torch.training import optimizer as opt
from repro_torch.training.data import TokenStream
from repro_torch.training.train_loop import TrainConfig, train

ROOT = Path(__file__).resolve().parents[1]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = float(np.abs(b).max()) or 1.0
    return float(np.abs(a - b).max()) / scale


def _np(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    """pair(name) -> (reference granite-3-2b smoke model, its params,
    the port's model on the same weights), float32."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as ref_get
    from repro.configs import smoke_variant as ref_smoke
    from repro.models import Model as RefModel
    ref = RefModel(ref_smoke(ref_get("granite-3-2b")).replace(
        dtype=jnp.float32))
    params = ref.init(jax.random.key(0))
    cfg = smoke_variant(get_config("granite-3-2b")).replace(
        dtype=torch.float32)
    port = Model(cfg, device="cpu")
    port.load_state_dict(params_from_jax(_np(params), cfg))
    return lambda name: (ref, params, port)


# -- the train step -----------------------------------------------------------

@pytest.mark.parametrize("k,compress", [(1, False), (2, False), (1, True),
                                        (2, True)])
def test_train_step_matches_reference(pair, k, compress):
    """`make_train_step` with 1 and 2 microbatches, with and without
    compression, against the reference's: loss, grad_norm, lr and every
    parameter after the step. The codec takes one scale per stacked leaf
    of the reference (`Model.stacked_leaves`) and is alone bitwise the
    reference's (`test_compress_decompress_bitwise`). In the step a
    gradient element within the two packages' float32 difference of a
    rounding boundary takes the neighbouring int8 level, and AdamW's
    first step, lr * g / |g|, then moves it by up to lr more or less.
    Measured over five seeds (init key and stream seed 0-4, k = 1 and
    2): grad_norm within 1.2e-6 and compression_err_sq within 1.4e-6
    relative, at most 1 such element of 106,816; the limits are about
    ten times those (1e-5 relative, 1e-4 of the elements)."""
    import jax
    import jax.numpy as jnp
    from repro.launch import steps as ref_steps
    from repro.training.data import TokenStream
    from repro.training.optimizer import AdamWConfig
    ref, params, port = pair("granite-3-2b")
    batch = next(TokenStream(512, 24, 4, seed=0).batches(1))
    ocfg = dict(lr=1e-3, warmup_steps=20, total_steps=400)
    rstep = jax.jit(ref_steps.make_train_step(
        ref, AdamWConfig(**ocfg), microbatches=k, grad_compression=compress))
    rp, _, rm = rstep(params, ref_steps.init_opt_state(params, compress),
                      {key: jnp.asarray(v) for key, v in batch.items()})
    model = Model(port.cfg, device="cpu")
    model.load_state_dict(port.state_dict())
    state = init_opt_state(model, compression=compress)
    step = make_train_step(model, opt.AdamWConfig(**ocfg), microbatches=k,
                           grad_compression=compress)
    state, pm = step(state, batch)
    assert ("ef" in state) == compress and int(state["step"]) == 1
    assert _rel(pm["loss"], float(rm["loss"])) <= 1e-6
    assert float(pm["aux"]) == float(rm["aux"])
    assert _rel(pm["lr"], float(rm["lr"])) <= 1e-6
    want = params_from_jax(_np(rp), model.cfg)
    if not compress:
        assert _rel(pm["grad_norm"], float(rm["grad_norm"])) <= 1e-5
        for name, p in model.named_parameters():
            assert _rel(p.detach(), want[name]) <= 1e-5, name
        return
    lr = float(rm["lr"])
    assert _rel(pm["grad_norm"], float(rm["grad_norm"])) <= 1e-5
    assert _rel(pm["compression_err_sq"],
                float(rm["compression_err_sq"])) <= 1e-5
    n = off = 0
    for name, p in model.named_parameters():
        d = (p.detach() - want[name]).abs()
        tol = 1e-5 * float(want[name].abs().max())
        assert float(d.max()) <= lr + tol, name
        n += d.numel()
        off += int((d > tol).sum())
    assert off <= 1e-4 * n, (off, n)


def test_train_step_with_compression_needs_error_buffers(pair):
    _, _, port = pair("granite-3-2b")
    step = make_train_step(port, opt.AdamWConfig(), grad_compression=True)
    with pytest.raises(ValueError, match="'ef' buffers"):
        step(init_opt_state(port), {})



# -- the loop -----------------------------------------------------------------

def _tiny():
    return Model(smoke_variant(ARCHS["granite-3-2b"]).replace(vocab=256),
                 device="cpu")


def test_loss_decreases():
    out = train(_tiny(), TokenStream(256, 32, 8, seed=0),
                TrainConfig(n_steps=40, log_every=100), log=lambda s: None)
    assert out["final_loss"] < out["first_loss"] - 0.3, \
        (out["first_loss"], out["final_loss"])


def test_train_with_compression():
    out = train(_tiny(), TokenStream(256, 32, 8, seed=0),
                TrainConfig(n_steps=25, grad_compression=True,
                            log_every=100), log=lambda s: None)
    assert "ef" in out["opt_state"]
    assert out["final_loss"] < out["first_loss"] - 0.2


@pytest.mark.parametrize("compress", [False, True])
def test_cut_and_resumed_run_is_the_uncut_run_bitwise(tmp_path, compress):
    def run(n_steps, ckpt, skip=0):
        data = TokenStream(256, 32, 8, seed=0)
        for _ in range(skip):          # the batches consumed before the cut
            next(data.batches(1))
        return train(_tiny(), data,
                     TrainConfig(n_steps=n_steps, ckpt_every=10,
                                 ckpt_dir=str(ckpt),
                                 grad_compression=compress),
                     log=lambda s: None)
    full = run(25, tmp_path / "full")
    run(15, tmp_path / "cut")
    resumed = run(25, tmp_path / "cut", skip=10)
    assert len(resumed["losses"]) == 15
    np.testing.assert_array_equal(resumed["losses"], full["losses"][10:])
    for k, p in full["params"].items():
        assert torch.equal(resumed["params"][k], p), k
    for part in ("m", "v") + (("ef",) if compress else ()):
        for k, t in full["opt_state"][part].items():
            assert torch.equal(resumed["opt_state"][part][k], t), (part, k)
    assert int(resumed["opt_state"]["step"]) == 25


def test_checkpoint_keeps_bfloat16_bits(tmp_path):
    """bfloat16 leaves go through a 16-bit integer view: restored bit for
    bit, in their dtype."""
    model = Model(smoke_variant(ARCHS["granite-3-2b"]), device="cpu")
    out = train(model, TokenStream(512, 16, 2, seed=1),
                TrainConfig(n_steps=2, ckpt_every=2,
                            ckpt_dir=str(tmp_path)), log=lambda s: None)
    again = Model(model.cfg, device="cpu", seed=5)
    restored = train(again, TokenStream(512, 16, 2, seed=1),
                     TrainConfig(n_steps=2, ckpt_dir=str(tmp_path)),
                     log=lambda s: None)
    assert len(restored["losses"]) == 0
    for k, p in out["params"].items():
        assert p.dtype == torch.bfloat16
        assert torch.equal(restored["params"][k], p), k


# -- the launchers ------------------------------------------------------------

def test_launcher_runs_on_the_cpu(capsys):
    out = launcher.main(["--smoke", "--steps", "3", "--batch", "2",
                         "--seq", "16", "--device", "cpu",
                         "--microbatches", "2", "--compress-grads"])
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert "granite-3-2b" in capsys.readouterr().out


def test_launcher_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        launcher.main(["--smoke", "--steps", "1"])


def test_example_runs_on_the_cpu(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "torch_train_small", ROOT / "examples" / "torch_train_small.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--device", "cpu", "--steps", "3",
                    "--ckpt", str(tmp_path)])
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()

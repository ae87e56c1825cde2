"""The reference's side of the mesh tests, run as a script in a process of
its own (not a test module), because the reference needs host devices:

    XLA_FLAGS=--xla_force_host_platform_device_count=N \\
        python tests/torch_mesh_reference.py IN.pkl OUT.pkl

IN.pkl holds {MODE: argument}, OUT.pkl gets {MODE: result}.

Meshes are built with `jax.make_mesh(..., axis_types=(Auto,) * n)`: the
reference's `constrain` refers to its axes through
`with_sharding_constraint`, which needs Auto axes, and `jax.make_mesh`
makes Explicit ones by default (the reference's own
`make_production_mesh` does, so it is not called here).

The modes:
  * moe       - `moe_layer_sharded` on a (data 2, model 2) mesh for each
                case, the whole batch and its first 3 rows, and each data
                half's kept (token, choice) pairs from the reference's
                own top-k and capacity rule;
  * allreduce - `shardmap_allreduce` on (data 2, model 1) (the first 2
                devices) and (data 2, model 2) meshes;
  * model     - the smoke model drawn from `jax.random.key(0)`, prefill
                and greedy decode steps under `sharding_rules(mesh,
                residual=residual_spec(mesh))` on (data 2, model 2);
  * lower     - `lower_cell`'s `meta` for each (arch, shape, multi_pod)
                on the production meshes' shapes (512 devices);
  * walk      - smoke cells' steps lowered by the reference's
                `lower_cell` on a small mesh, compiled and walked as its
                dry run walks them (FLOPs, collectives by kind);
  * train     - one train step of a smoke model (`make_train_step` with
                the case's AdamW config, microbatches and compression)
                jitted with `lower_cell`'s shardings (the case's FSDP
                rule) on a (data, model) mesh of the 4 host devices under
                the residual rule, as the reference's dry run lowers a
                train cell; MoE takes its capacity per data shard there;
  * tp        - smoke models unsharded, prefill and greedy decode over
                given row ranges (the tensor-parallel tests' reference:
                the reference's placement plans change where its values
                live, not the values, so its one-device step is the
                spec; a data shard's rows run on their own, as its MoE
                capacity is taken per shard).
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType


def auto_mesh(shape, names, devices=None):
    kw = {} if devices is None else {"devices": devices}
    return jax.make_mesh(shape, names,
                         axis_types=(AxisType.Auto,) * len(shape), **kw)


def kept_pairs(x, router, k, cf, no_drop):
    """The reference's kept (token, choice) pairs of `moe_layer` on x, by
    its own top-k, one-hot cumsum and capacity."""
    x2 = jnp.asarray(x).reshape(-1, x.shape[-1]).astype(jnp.float32)
    probs = jax.nn.softmax(x2 @ jnp.asarray(router), axis=-1)
    flat = np.asarray(jax.lax.top_k(probs, k)[1]).reshape(-1)
    T, E = x2.shape[0], router.shape[1]
    C = T if no_drop else max(1, int(cf * k * T / E))
    rank = np.cumsum(np.eye(E, dtype=np.int64)[flat], axis=0)[
        np.arange(flat.size), flat] - 1
    return C, rank < C


def run_moe(cases):
    from repro.distributed.shardctx import sharding_rules
    from repro.models.moe import moe_layer_sharded
    mesh = auto_mesh((2, 2), ("data", "model"))
    out = {}
    for name, case in cases.items():
        dt = jnp.dtype(case["dtype"])
        x = jnp.asarray(case["x"]).astype(dt)
        p = {k: jnp.asarray(v).astype(jnp.float32 if k == "router" else dt)
             for k, v in case["p"].items()}
        res = {}
        with sharding_rules(mesh):
            for how, xs in (("whole", x), ("fallback", x[:3])):
                o, aux = moe_layer_sharded(xs, p, **case["kw"])
                res[how] = dict(out=np.asarray(o.astype(jnp.float32)),
                                aux=float(aux))
        kw = case["kw"]
        half = x.shape[0] // 2
        res["kept"] = [kept_pairs(x[j * half:(j + 1) * half], p["router"],
                                  kw["top_k"], kw["capacity_factor"],
                                  kw.get("no_drop", False))
                       for j in range(2)]
        res["kept_fallback"] = kept_pairs(x[:3], p["router"], kw["top_k"],
                                          kw["capacity_factor"],
                                          kw.get("no_drop", False))
        out[name] = res
    return out


def run_allreduce(cases):
    from repro.distributed.compression import shardmap_allreduce
    meshes = {(2, 1): auto_mesh((2, 1), ("data", "model"),
                                devices=jax.devices()[:2]),
              (2, 2): auto_mesh((2, 2), ("data", "model"))}
    out = {}
    for name, case in cases.items():
        x = jnp.asarray(case["same"]).astype(jnp.dtype(case["dtype"]))
        for shape, mesh in meshes.items():
            for axes in case["axes"]:
                y = shardmap_allreduce(x, mesh, axes=axes)
                out[(name, shape, axes)] = (
                    np.asarray(y.astype(jnp.float32)), str(y.dtype))
    return out


def run_model(case):
    from repro.configs import ARCHS, smoke_variant
    from repro.distributed.shardctx import sharding_rules
    from repro.launch.sharding import residual_spec
    from repro.models import Model
    from repro.models.api import greedy_sample
    cfg = smoke_variant(ARCHS[case["arch"]]).replace(dtype=jnp.float32)
    model = Model(cfg)
    params = model.init(jax.random.key(0))
    mesh = auto_mesh((2, 2), ("data", "model"))
    logits = []
    with sharding_rules(mesh, residual=residual_spec(mesh)):
        lg, cache = model.prefill(params,
                                  {"tokens": jnp.asarray(case["tokens"])},
                                  pad_to=case["pad_to"])
        logits.append(np.asarray(lg))
        for _ in range(case["steps"]):
            lg, cache = model.decode(params, cache,
                                     greedy_sample(lg)[:, None])
            logits.append(np.asarray(lg))
    return dict(params=jax.tree.map(np.asarray, params), logits=logits)


def run_tp(cases):
    """Each case's smoke model (float32, drawn from `jax.random.key(0)`)
    unsharded: prefill and greedy decode steps over each row range of
    `rows` on its own, so a MoE layer takes its capacity from that range's
    tokens, as it does per data shard under a mesh."""
    from repro.configs import ARCHS, smoke_variant
    from repro.models import Model
    from repro.models.api import greedy_sample
    out = {}
    for name, case in cases.items():
        cfg = smoke_variant(ARCHS[case["arch"]]).replace(dtype=jnp.float32)
        model = Model(cfg)
        params = model.init(jax.random.key(0))
        res = {"params": jax.tree.map(np.asarray, params)}
        for lo, hi in case["rows"]:
            batch = {k: jnp.asarray(v[lo:hi])
                     for k, v in case["batch"].items()}
            lg, cache = model.prefill(params, batch, pad_to=case["pad_to"])
            logits = [np.asarray(lg)]
            for _ in range(case["steps"]):
                lg, cache = model.decode(params, cache,
                                         greedy_sample(lg)[:, None])
                logits.append(np.asarray(lg))
            res[(lo, hi)] = logits
        out[name] = res
    return out


def run_train(cases):
    """{name: dict(arch, mesh, batch, ocfg[, state0 (the moments "m",
    "v" to start from), fsdp, microbatches, compression, remat])} ->
    {name: dict(params (before), new_params,
    m, v, mets)}, numpy; the model is the smoke variant in float32 with
    the vocabulary padded to 256 (`lower_cell`'s), drawn from
    `jax.random.key(0)`."""
    from jax.sharding import PartitionSpec as P
    from repro.configs import ARCHS, smoke_variant
    from repro.distributed.shardctx import sharding_rules
    from repro.launch import sharding as shr
    from repro.launch.steps import init_opt_state, make_train_step
    from repro.models import Model
    from repro.training import optimizer as opt
    out = {}
    for name, case in cases.items():
        cfg = smoke_variant(ARCHS[case["arch"]]).replace(
            dtype=jnp.float32, vocab_pad_to=256,
            remat=case.get("remat", False))
        model = Model(cfg)
        params = model.init(jax.random.key(0))
        mesh = auto_mesh(case["mesh"], ("data", "model"))
        batch = {k: jnp.asarray(v) for k, v in case["batch"].items()}
        comp = case.get("compression", False)
        psh = shr.to_named(shr.param_pspecs(params, mesh,
                                            fsdp=case.get("fsdp", False)),
                           mesh)
        ospec = shr.opt_pspecs(params, mesh)
        osh = shr.to_named({"m": ospec["m"], "v": ospec["v"], "step": P()},
                           mesh)
        if comp:
            osh["ef"] = psh
        bsh = shr.to_named(shr.batch_pspecs(batch, mesh), mesh)
        with sharding_rules(mesh, residual=shr.residual_spec(mesh)):
            fn = jax.jit(make_train_step(
                model, opt.AdamWConfig(**case["ocfg"]),
                microbatches=case.get("microbatches", 1),
                grad_compression=comp),
                in_shardings=(psh, osh, bsh), out_shardings=(psh, osh, None))
            state = init_opt_state(params, comp)
            if case.get("state0") is not None:
                state = dict(state, **{k: jax.tree.map(jnp.asarray, v)
                                       for k, v in case["state0"].items()})
            new, state, mets = fn(params, state, batch)
        out[name] = dict(params=jax.tree.map(np.asarray, params),
                         new_params=jax.tree.map(np.asarray, new),
                         m=jax.tree.map(np.asarray, state["m"]),
                         v=jax.tree.map(np.asarray, state["v"]),
                         mets={k: float(v) for k, v in mets.items()})
    return out


def run_lower(cells):
    from repro.configs import get_config
    from repro.launch.steps import lower_cell
    from repro.models.config import SHAPES
    meshes = {False: auto_mesh((16, 16), ("data", "model")),
              True: auto_mesh((2, 16, 16), ("pod", "data", "model"))}
    out = {}
    for arch, shape, multi_pod in cells:
        mesh = meshes[multi_pod]
        with mesh:
            _, meta = lower_cell(get_config(arch), SHAPES[shape], mesh)
        out[(arch, shape, multi_pod)] = meta
    return out


def run_walk(cells):
    """Each (arch, shape (name, seq_len, batch, kind), mesh shape)
    cell: the smoke config's step lowered by the reference's
    `lower_cell` on a ("data", "model") mesh of the host devices,
    compiled, and its HLO walked as the reference's dry run walks it
    (`benchmarks.hlo_cost.analyze`): FLOPs and collectives by kind."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from benchmarks.hlo_cost import analyze
    from repro.configs import get_config, smoke_variant
    from repro.launch.steps import lower_cell
    from repro.models.config import ShapeSpec
    out = {}
    for arch, shape, mesh_shape in cells:
        mesh = auto_mesh(mesh_shape, ("data", "model"))
        with mesh:
            lowered, _ = lower_cell(smoke_variant(get_config(arch)),
                                    ShapeSpec(*shape), mesh)
            walk = analyze(lowered.compile().as_text())
        out[(arch, shape, mesh_shape)] = dict(flops=walk["flops"],
                                              by_kind=walk["by_kind"])
    return out


def run_reference(args, devices, tmp_path, timeout=600):
    """Run {MODE: argument} through this script with `devices` host
    devices, in a subprocess bounded by `timeout` seconds; returns {MODE:
    result}."""
    return start_reference(args, devices, tmp_path, timeout)()


def start_reference(args, devices, tmp_path, timeout=600):
    """`run_reference` started in the background: returns a function that
    waits for the subprocess and returns {MODE: result}."""
    src, dst = Path(tmp_path) / "ref_in.pkl", Path(tmp_path) / "ref_out.pkl"
    with open(src, "wb") as fh:
        pickle.dump(args, fh)
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={devices}",
           "PYTHONPATH": os.pathsep.join(
               [str(root / "src"), str(root / "tests"),
                os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.Popen([sys.executable, __file__, str(src), str(dst)],
                            env=env, cwd=root, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)

    def wait():
        try:
            _, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise
        if proc.returncode:
            raise RuntimeError(f"reference run failed:\n{err[-4000:]}")
        with open(dst, "rb") as fh:
            return pickle.load(fh)
    return wait


MODES = {"moe": run_moe, "allreduce": run_allreduce, "model": run_model,
         "lower": run_lower, "tp": run_tp, "walk": run_walk,
         "train": run_train}


def main():
    src, dst = sys.argv[1:3]
    with open(src, "rb") as fh:
        args = pickle.load(fh)
    out = {mode: MODES[mode](arg) for mode, arg in args.items()}
    with open(dst, "wb") as fh:
        pickle.dump(out, fh)


if __name__ == "__main__":
    main()

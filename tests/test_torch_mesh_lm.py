"""The LM on a mesh of 8 ranks (``models/{layers,ssm,lm}`` and
``launch/{serve,train}`` under ``use_rules`` on a ``DeviceMesh``) against
the JAX package's under ``use_rules`` on 8 forced host devices.

8 gloo ranks (``tests/test_torch_sharding.py``'s harness: spawned, a
``file://`` store, a 60 s group timeout) build a (2, 4) ("data",
"model") mesh, lay JAX's f32 weights out by the parameter specs and run,
for all ten smoke configs, ``loss_fn`` and a prefill with 2 decode steps;
then one train step each of gemma3, moonshot with ``moe_dispatch=
"capacity"`` (the expert-parallel dispatch, forward and backward) and
rwkv6; and ``moe_block``'s expert-parallel output beside
``_capacity_dispatch`` on the same inputs. Beside them a subprocess runs
JAX on a (2, 4) mesh of ``AxisType.Auto`` axes (JAX's own ``shard``
raises on ``jax.make_mesh``'s default ``Explicit`` axes under jax 0.9).
The port without a mesh is the third witness.

Bounds: ``tests/test_torch_serve.py``'s 1e-4 x scale + 1e-5 for logits
and losses; ``tests/test_torch_train.py``'s for the train step (loss
1e-5, ``grad_norm`` 1e-4 relative, parameters within 2 x lr + 2e-6). Each rank's local parameter shapes must equal JAX's
``shard_shape`` for the same mesh coordinates.

Spawned ranks import this module, so its top level imports no JAX.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_sharding import init_rank, spawn_ranks

ARCHS = ("stablelm-3b", "minitron-8b", "gemma3-1b", "granite-20b",
         "qwen3-moe-235b-a22b", "moonshot-v1-16b-a3b", "internvl2-1b",
         "whisper-base", "zamba2-1.2b", "rwkv6-1.6b")
TRAIN = ("gemma3-1b", "moonshot-v1-16b-a3b", "rwkv6-1.6b")
MESH = (2, 4)
B, S, PROMPT, MAX_LEN = 4, 18, 16, 24
DEADLINE_S = 240


def _cfg(arch, module, train=False):
    """The f32 smoke config of ``arch`` in either package (the train
    cells' MoE with capacity dispatch)."""
    cfg = dataclasses.replace(module.SMOKE_CONFIGS[arch], dtype="float32")
    if train and cfg.family == "moe":
        cfg = dataclasses.replace(cfg, moe_dispatch="capacity")
    return cfg


def _flat(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, path + (k,)))
        elif v is not None:
            out["/".join(path + (k,))] = v
    return out


def _unflat(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *head, last = key.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


def _batch(cfg, seed):
    """Seeded tokens (the prompt and 2 decode tokens), the prompt's
    next-token labels and the stub modality inputs."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": tokens,
             "labels": np.roll(tokens[:, :PROMPT], -1, 1)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.patch_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (B, cfg.num_mem_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _loss_batch(batch):
    """The training batch: the prompt's tokens and labels."""
    return dict(batch, tokens=batch["tokens"][:, :PROMPT])


def _serve_inputs(batch):
    extras = {k: batch[k] for k in ("patch_embeds", "frames") if k in batch}
    return batch["tokens"][:, :PROMPT], extras


# --------------------------------------------------------------- ranks

def _lm_rank(rank, store, data_dir, out_dir):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import configs as TCF
    from repro_torch.distributed import sharding as TS
    from repro_torch.launch import train as TTR
    from repro_torch.models import layers as TLY
    from repro_torch.models import lm as TLM
    from repro_torch.optim import adamw_init
    init_rank(rank, 8, store)
    try:
        mesh = init_device_mesh("cpu", MESH, mesh_dim_names=("data",
                                                            "model"))
        rules = TS.SINGLE_POD_RULES
        res = {"coord": np.asarray(mesh.get_coordinate())}

        def full(t):
            return (t.full_tensor() if hasattr(t, "full_tensor") else t
                    ).detach().numpy()

        def place(cfg, flat):
            specs = _flat(TLM.param_specs(cfg))
            return _unflat({k: TS.shard(torch.as_tensor(v), *specs[k].axes)
                            for k, v in flat.items()})

        def rows(a):
            a = torch.as_tensor(a)
            return TS.shard(a, "batch", *([None] * (a.ndim - 1)))

        for arch in ARCHS + tuple("train:" + a for a in TRAIN):
            train = arch.startswith("train:")
            name = arch.split(":")[-1]
            cfg = _cfg(name, TCF, train)
            data = dict(np.load(os.path.join(data_dir, f"{name}.npz")))
            batch = {k[2:]: v for k, v in data.items() if k[:2] == "b:"}
            flat = {k[2:]: v for k, v in data.items() if k[:2] == "p:"}
            with TS.use_rules(rules, mesh):
                params = place(cfg, flat)
                if not train:
                    for k, t in _flat(params).items():
                        res[f"{name}|shape|{k}"] = np.asarray(
                            t.to_local().shape)
                    loss, _ = TLM.loss_fn(cfg, params,
                                          {k: rows(v) for k, v in
                                           _loss_batch(batch).items()})
                    res[f"{name}|loss"] = full(loss)
                    prompt, extras = _serve_inputs(batch)
                    with torch.inference_mode():
                        logits, cache = TLM.prefill(
                            cfg, params, rows(prompt), MAX_LEN,
                            cache_dtype=torch.float32,
                            **{k: rows(v) for k, v in extras.items()})
                        res[f"{name}|prefill"] = full(logits)
                        for t in range(PROMPT, S):
                            logits, cache = TLM.decode_step(
                                cfg, params, cache,
                                rows(batch["tokens"][:, t:t + 1]))
                            res[f"{name}|decode{t}"] = full(logits)
                    continue
                step = TTR.make_train_step(cfg, TTR.default_optimizer())
                dbatch = {k: rows(v) for k, v in _loss_batch(batch).items()}
                new, _, metrics = step(params, adamw_init(params), dbatch)
                for k in ("loss", "grad_norm", "lr"):
                    res[f"train:{name}|{k}"] = full(metrics[k])
                for k, t in _flat(new).items():
                    res[f"train:{name}|p|{k}"] = full(t)
        # moe_block's EP output beside _capacity_dispatch, same inputs
        cfg = _cfg("moonshot-v1-16b-a3b", TCF, train=True)
        data = dict(np.load(os.path.join(data_dir,
                                         "moonshot-v1-16b-a3b.npz")))
        moe = {k.split("/")[-1]: torch.as_tensor(v[0])
               for k, v in data.items() if k.startswith("p:layers/moe/")}
        x = torch.as_tensor(np.random.default_rng(5).standard_normal(
            (B, S, cfg.d_model)).astype(np.float32))
        xn = TLY.rms_norm(x, moe["ln"], cfg.norm_eps)
        _, combine = TLY._route(torch.einsum("bsd,de->bse", xn,
                                             moe["router"]),
                                cfg.experts_per_token, cfg.num_experts)
        act = TLY.activation(cfg)
        res["ep_plain"] = TLY._capacity_dispatch(moe, xn, combine, cfg,
                                                 act).numpy()
        specs = _flat(TLM.param_specs(cfg)["layers"]["moe"])
        with TS.use_rules(rules, mesh):
            dm = {k: TS.shard(v, *specs[k].axes[1:]) for k, v in moe.items()}
            ep = TLY._capacity_dispatch_ep(dm, rows(xn), rows(combine), cfg,
                                           act, rules, mesh)
            res["ep_local_shape"] = np.asarray(ep.to_local().shape)
            res["ep"] = full(ep)
            out, _ = TLY.moe_block(dm, rows(x), cfg)
            res["ep_block"] = full(out)
        res["ep_block_plain"] = TLY.moe_block(moe, x, cfg)[0].numpy()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------- JAX

def _jax_side(data_dir, out_path):
    """On 8 forced host devices, a (2, 4) Auto mesh: the same cells."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding
    from repro import configs as JCF
    from repro.distributed import sharding as JS
    from repro.launch import train as JTR
    from repro.models import lm as JLM
    from repro.optim import adamw_init
    assert jax.device_count() == 8, jax.device_count()
    mesh = jax.make_mesh(MESH, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    rules = JS.SINGLE_POD_RULES
    out, shapes = {}, {}
    coords = {}
    for dev in mesh.devices.flat:
        coords[dev] = ",".join(
            str(int(c)) for c in np.argwhere(mesh.devices == dev)[0])
    for arch in ARCHS + tuple("train:" + a for a in TRAIN):
        train = arch.startswith("train:")
        name = arch.split(":")[-1]
        cfg = _cfg(name, JCF, train)
        data = dict(np.load(os.path.join(data_dir, f"{name}.npz")))
        batch = {k[2:]: jnp.asarray(v) for k, v in data.items()
                 if k[:2] == "b:"}
        specs = _flat(JLM.param_specs(cfg))
        shard = {k: NamedSharding(mesh, JS.logical_spec(
            specs[k].shape, specs[k].axes, rules, mesh)) for k in specs}
        params = _unflat({k[2:]: jax.device_put(v, shard[k[2:]])
                          for k, v in data.items() if k[:2] == "p:"})
        with JS.use_rules(rules, mesh):
            if not train:
                for k, sh in shard.items():
                    shapes[f"{name}|{k}"] = {
                        coords[d]: [[s.start or 0, s.stop or n]
                                    for s, n in zip(idx, specs[k].shape)]
                        for d, idx in sh.devices_indices_map(
                            specs[k].shape).items()}
                loss, _ = jax.jit(lambda p, b: JLM.loss_fn(cfg, p, b))(
                    params, _loss_batch(batch))
                out[f"{name}|loss"] = np.asarray(loss)
                prompt = batch["tokens"][:, :PROMPT]
                extras = {k: batch[k] for k in ("patch_embeds", "frames")
                          if k in batch}
                logits, cache = jax.jit(lambda p, t, e: JLM.prefill(
                    cfg, p, t, MAX_LEN, cache_dtype=jnp.float32, **e))(
                        params, prompt, extras)
                out[f"{name}|prefill"] = np.asarray(logits)
                step = jax.jit(lambda p, c, t: JLM.decode_step(cfg, p, c, t))
                for t in range(PROMPT, S):
                    logits, cache = step(params, cache,
                                         batch["tokens"][:, t:t + 1])
                    out[f"{name}|decode{t}"] = np.asarray(logits)
                continue
            new, _, metrics = jax.jit(JTR.make_train_step(
                cfg, JTR.default_optimizer()))(params, adamw_init(params),
                                               _loss_batch(batch))
        for k in ("loss", "grad_norm", "lr"):
            out[f"train:{name}|{k}"] = np.asarray(metrics[k])
        for k, v in _flat(new).items():
            out[f"train:{name}|p|{k}"] = np.asarray(v)
    out["shapes"] = np.asarray(json.dumps(shapes))
    np.savez(out_path, **out)


# ------------------------------------------------------------- fixture

@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """JAX's weights and batches written once; JAX in a subprocess and
    the port on 8 spawned ranks side by side; both read back, with the
    port's unmeshed outputs beside them."""
    import jax
    from repro import configs as JCF
    from repro.models import lm as JLM
    out = tmp_path_factory.mktemp("mesh_lm")
    for i, arch in enumerate(ARCHS):
        cfg = _cfg(arch, JCF)
        p = JLM.init_params(cfg, jax.random.PRNGKey(i))
        arrays = {f"p:{k}": np.asarray(v) for k, v in _flat(p).items()}
        arrays.update({f"b:{k}": v for k, v in _batch(cfg, i).items()})
        np.savez(out / f"{arch}.npz", **arrays)
    jax_out = str(out / "jax.npz")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(root, "src"), root, os.path.join(root, "tests")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    jproc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "jax-mesh-lm",
         str(out), jax_out], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        spawn_ranks(_lm_rank, 8, (str(out / "store"), str(out), str(out)),
                    DEADLINE_S)
        _, err = jproc.communicate(timeout=DEADLINE_S)
    finally:
        if jproc.poll() is None:
            jproc.kill()
            jproc.communicate()
    assert jproc.returncode == 0, err[-3000:]
    want = dict(np.load(jax_out))
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(8)]
    return want, ranks, str(out)


def _plain(arch, data_dir):
    """The port without a mesh on the same weights and batch."""
    from repro_torch import configs as TCF
    from repro_torch.models import lm as TLM
    cfg = _cfg(arch, TCF)
    data = dict(np.load(os.path.join(data_dir, f"{arch}.npz")))
    params = _unflat({k[2:]: torch.as_tensor(v) for k, v in data.items()
                      if k[:2] == "p:"})
    batch = {k[2:]: torch.as_tensor(v) for k, v in data.items()
             if k[:2] == "b:"}
    res = {"loss": TLM.loss_fn(cfg, params, _loss_batch(batch))[0]
           .detach().numpy()}
    prompt, extras = _serve_inputs(batch)
    with torch.inference_mode():
        logits, cache = TLM.prefill(cfg, params, prompt, MAX_LEN,
                                    cache_dtype=torch.float32, **extras)
        res["prefill"] = logits.numpy()
        for t in range(PROMPT, S):
            logits, cache = TLM.decode_step(cfg, params, cache,
                                            batch["tokens"][:, t:t + 1])
            res[f"decode{t}"] = logits.numpy()
    return res


def _within(ref, got):
    ref, got = np.asarray(ref, np.float32), np.asarray(got, np.float32)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    diff, scale = float(np.abs(ref - got).max()), float(np.abs(ref).max())
    assert np.isfinite(got).all() and diff <= 1e-4 * scale + 1e-5, (
        diff, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_prefill_decode_equal_jax(mesh_runs, arch):
    """``loss_fn``, the prefill's logits and 2 decode steps' on 8 ranks
    against JAX's on its mesh and against the port without a mesh."""
    want, ranks, data_dir = mesh_runs
    plain = _plain(arch, data_dir)
    keys = ["loss", "prefill"] + [f"decode{t}" for t in range(PROMPT, S)]
    for k in keys:
        got = ranks[0][f"{arch}|{k}"]
        _within(want[f"{arch}|{k}"], got)
        _within(plain[k], got)
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[f"{arch}|{k}"], got)


@pytest.mark.parametrize("arch", ARCHS)
def test_local_param_shapes_equal_jax(mesh_runs, arch):
    """Every rank's local shard of every parameter has the shape JAX's
    sharding gives the device at the same mesh coordinates."""
    want, ranks, _ = mesh_runs
    shapes = json.loads(str(want["shapes"]))
    seen = set()
    for r in ranks:
        coord = ",".join(map(str, r["coord"]))
        seen.add(coord)
        keys = [k for k in r if k.startswith(f"{arch}|shape|")]
        assert keys
        for k in keys:
            leaf = k.split("|")[-1]
            sl = shapes[f"{arch}|{leaf}"][coord]
            assert tuple(r[k]) == tuple(b - a for a, b in sl), (k, coord)
    assert len(seen) == 8


@pytest.mark.parametrize("arch", TRAIN)
def test_train_step_equal_jax(mesh_runs, arch):
    """One f32 train step on 8 ranks against JAX's on its mesh: loss
    1e-5, ``grad_norm`` 1e-4, ``lr`` 1e-6 relative, every updated
    parameter within 2 x lr + 2e-6 (at most 1e-3 of them past lr/2)."""
    want, ranks, _ = mesh_runs
    got = ranks[0]
    tol = {"loss": 1e-5, "grad_norm": 1e-4, "lr": 1e-6}
    for k, rel in tol.items():
        assert float(got[f"train:{arch}|{k}"]) == pytest.approx(
            float(want[f"train:{arch}|{k}"]), rel=rel, abs=1e-7), k
    lr = float(want[f"train:{arch}|lr"])
    keys = [k for k in want if k.startswith(f"train:{arch}|p|")]
    assert keys and set(keys) == {k for k in got
                                  if k.startswith(f"train:{arch}|p|")}
    for k in keys:
        d = np.abs(want[k] - got[k])
        assert d.max() <= 2 * lr + 2e-6, (k, d.max(), lr)
        assert (d > lr / 2).mean() <= 1e-3, (k, (d > lr / 2).mean())


def test_expert_parallel_equals_capacity_dispatch(mesh_runs):
    """``_capacity_dispatch_ep`` on 8 ranks (2 of moonshot's 8 smoke
    experts a ``model`` rank, its rows a ``data`` rank) equals
    ``_capacity_dispatch`` on the same inputs, and ``moe_block`` under the
    mesh equals it without one (the sum over ``model`` adds in another
    order: within 1e-5 x scale)."""
    _, ranks, _ = mesh_runs
    for r in ranks:
        assert tuple(r["ep_local_shape"]) == (B // MESH[0], S, 64)
        for a, b in (("ep_plain", "ep"), ("ep_block_plain", "ep_block")):
            scale = float(np.abs(r[a]).max())
            assert np.abs(r[a] - r[b]).max() <= 1e-5 * scale, (a, b)


if __name__ == "__main__" and sys.argv[1:2] == ["jax-mesh-lm"]:
    _jax_side(sys.argv[2], sys.argv[3])

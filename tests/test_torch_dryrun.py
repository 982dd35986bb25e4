"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's lowering on the CPU.

``lower_cell`` runs smoke cells on a fake (2, 4) ("data", "model") group
of 8 ranks. For the same cells JAX lowers and compiles on 8 forced host
devices (a subprocess; a (2, 4) mesh of ``AxisType.Auto`` axes): each
rank's argument bytes must equal ``memory_analysis().
argument_size_in_bytes`` exactly, and the per-rank dot FLOPs must be
within 1% of ``analyze_hlo``'s, or differ by the op listed beside the
cell. Also: the record's keys, the ``SKIP`` record of a full-attention
architecture at ``long_500k``, skip-done, ``reanalyze`` on a saved trace,
and the command line on a production cell and ``--starling``.

The top level imports no JAX (the subprocess does).
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

from repro_torch.configs import SMOKE_CONFIGS
from repro_torch.configs.shapes import Shape
from repro_torch.launch import dryrun as TD

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = (2, 4)
# (arch, shape, config overrides, the port's FLOPs above JAX's, listed
# op by op; None: within 1%)
CELLS = [
    # gemma3's one KV head does not divide the 4 model ranks: the port
    # computes the k and v projections whole on every model rank, where
    # GSPMD splits them 4 ways: 4 layers x (k, v) x 2 x 4 rows x 64 x 16
    # x (1 - 1/4)
    ("gemma3-1b", Shape("decode_s", "decode", 64, 8), {},
     4 * 2 * 2 * 4 * 64 * 16 * 3 // 4),
    ("stablelm-3b", Shape("prefill_s", "prefill", 32, 8), {}, None),
    ("moonshot-v1-16b-a3b", Shape("train_s", "train", 32, 8),
     {"moe_dispatch": "capacity"}, None),
    ("whisper-base", Shape("prefill_s", "prefill", 32, 8), {}, None),
    # the WKV scan: the port batches the chunk terms over the chunks and
    # runs the recurrence alone chunk by chunk; JAX's scan body
    # computes every term a chunk. Argument bytes only.
    ("rwkv6-1.6b", Shape("prefill_s", "prefill", 32, 8), {}, "scan"),
]
FLOP_CELLS = [c for c in CELLS if c[3] != "scan"]
KEYS = {"arch", "shape", "mesh", "kind", "tag", "lower_s", "compile_s",
        "bytes_per_device", "hlo_path", "hlo_chars", "chips", "hlo_flops",
        "hlo_bytes_raw", "hlo_bytes", "collective_bytes", "collectives",
        "roofline", "memory_s_raw", "dominant", "model_flops",
        "model_flops_ratio"}


def _cfg(arch, overrides):
    return dataclasses.replace(SMOKE_CONFIGS[arch], **overrides)


def _jax_side(out_path):
    """Lower and compile each cell on 8 host devices: argument bytes and
    ``analyze_hlo``'s FLOPs."""
    import jax
    from jax.sharding import AxisType
    from repro.configs import SMOKE_CONFIGS as JS
    from repro.distributed.hlo import analyze_hlo
    from repro.distributed.sharding import use_rules
    from repro.launch.mesh import rules_for
    from repro.launch.serve import make_prefill, make_serve_step
    from repro.launch.specs import step_specs
    from repro.launch.train import default_optimizer, make_train_step
    mesh = jax.make_mesh(MESH, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    out = {}
    for arch, shape, overrides, _ in CELLS:
        cfg = dataclasses.replace(JS[arch], **overrides)
        kind, args = step_specs(cfg, shape, mesh)
        fn, donate = {"train": (make_train_step(cfg, default_optimizer()),
                                (0, 1)),
                      "prefill": (make_prefill(cfg, shape.seq_len), ()),
                      "decode": (make_serve_step(cfg), (1,))}[kind]
        with use_rules(rules_for(mesh), mesh):
            compiled = jax.jit(fn, donate_argnums=donate).lower(
                *args).compile()
        tot = analyze_hlo(compiled.as_text())
        out[f"{arch}|{shape.name}"] = {
            "argument": compiled.memory_analysis().argument_size_in_bytes,
            "flops": tot.flops}
    with open(out_path, "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module")
def jax_cells(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun_jax") / "jax.json")
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "jax-dryrun", out], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def port_cells(tmp_path_factory):
    """The same cells through ``lower_cell`` on a fake group of 8."""
    from torch.distributed.device_mesh import init_device_mesh
    out = str(tmp_path_factory.mktemp("dryrun_port") / "d.jsonl")
    recs = {}
    with TD.fake_world(8):
        mesh = init_device_mesh("cpu", MESH, mesh_dim_names=("data",
                                                            "model"))
        for arch, shape, overrides, _ in CELLS:
            recs[f"{arch}|{shape.name}"] = TD.lower_cell(
                arch, shape.name, False, out_path=out,
                cfg=_cfg(arch, overrides), shape=shape, mesh=mesh)
    return recs


@pytest.mark.parametrize("cell", CELLS, ids=[f"{c[0]}-{c[1].name}"
                                             for c in CELLS])
def test_argument_bytes_equal_jax(cell, jax_cells, port_cells):
    key = f"{cell[0]}|{cell[1].name}"
    assert (port_cells[key]["bytes_per_device"]["argument"]
            == jax_cells[key]["argument"])


@pytest.mark.parametrize("cell", FLOP_CELLS,
                         ids=[f"{c[0]}-{c[1].name}" for c in FLOP_CELLS])
def test_flops_equal_jax_or_differ_by_the_listed_ops(cell, jax_cells,
                                                     port_cells):
    """Per-rank dot FLOPs within 1% of ``analyze_hlo``'s, or above them
    by exactly the ops listed beside the cell."""
    key = f"{cell[0]}|{cell[1].name}"
    got, want = port_cells[key]["hlo_flops"], jax_cells[key]["flops"]
    if cell[3] is None:
        assert got == pytest.approx(want, rel=0.01), (got, want)
    else:
        assert got - want == cell[3], (got, want)


def test_record_keys_and_trace(port_cells, tmp_path):
    """Every JAX key the port computes is there, the numbers are per
    rank and positive, the saved trace re-reads to the same totals."""
    from repro_torch.distributed.hlo import analyze_trace, load_trace
    for rec in port_cells.values():
        assert KEYS <= set(rec), KEYS - set(rec)
        assert rec["chips"] == 8
        bpd = rec["bytes_per_device"]
        assert set(bpd) == {"argument", "output", "temp", "alias", "peak",
                            "total"}
        assert bpd["peak"] >= bpd["argument"] > 0
        assert bpd["total"] == bpd["argument"] + bpd["temp"] - bpd["alias"]
        assert set(rec["roofline"]) == {"compute_s", "memory_s",
                                        "collective_s"}
        assert rec["dominant"] in rec["roofline"]
        tot = analyze_trace(load_trace(rec["hlo_path"]))
        assert tot.flops == rec["hlo_flops"]
        assert int(tot.collective_bytes) == rec["collective_bytes"]
    # the decode writes its cache in place: aliased, not output
    dec = port_cells["gemma3-1b|decode_s"]["bytes_per_device"]
    assert dec["alias"] > dec["output"]
    # the train step returns new trees
    assert port_cells["moonshot-v1-16b-a3b|train_s"][
        "bytes_per_device"]["alias"] == 0


def test_skip_record_skip_done_and_reanalyze(port_cells, tmp_path):
    out = str(tmp_path / "d.jsonl")
    TD.run_cells([("stablelm-3b", "long_500k", False)], out)
    with open(out) as f:
        rec = json.loads(f.readline())
    assert rec["status"] == "SKIP" and "sub-quadratic" in rec["skip_reason"]
    TD.run_cells([("stablelm-3b", "long_500k", False)], out)   # skip-done
    with open(out) as f:
        assert len(f.readlines()) == 1
    # reanalyze rebuilds the roofline fields from the saved trace
    rec = dict(port_cells["gemma3-1b|decode_s"], status="OK")
    want = {k: rec[k] for k in ("hlo_flops", "hlo_bytes", "hlo_bytes_raw",
                                "collective_bytes", "dominant")}
    spoiled = dict(rec, hlo_flops=0.0, hlo_bytes=0.0, dominant="x")
    with open(out, "w") as f:
        f.write(json.dumps(spoiled) + "\n")
    TD.reanalyze(out)
    with open(out) as f:
        again = json.loads(f.readline())
    assert {k: again[k] for k in want} == want


def test_command_line_production_cell_and_starling(tmp_path):
    """``--arch gemma3-1b --shape decode_32k --mesh both`` and
    ``--starling`` write OK records at full size, in a process of their
    own (each cell opens its own fake group of 256 or 512)."""
    out = str(tmp_path / "cli.jsonl")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    for argv in (["--arch", "gemma3-1b", "--shape", "decode_32k",
                  "--mesh", "both"], ["--starling"]):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
             "--out", out], env=env, capture_output=True, text=True,
            timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out) as f:
        recs = [json.loads(line) for line in f]
    assert [(r["arch"], r["mesh"], r["status"]) for r in recs] == [
        ("gemma3-1b", "pod16x16", "OK"), ("gemma3-1b", "pod2x16x16", "OK"),
        ("starling-search", "pod16x16", "OK"),
        ("starling-search", "pod2x16x16", "OK")]
    single, multi = recs[0], recs[1]
    assert single["chips"] == 256 and multi["chips"] == 512
    # 128 sequences over 16 (32) batch ranks: the cache is cut 16 ways on
    # its batch and 16 on its sequence (gemma3 has one KV head)
    cache = 2 * 26 * 128 * 32768 * 256 * 2
    assert single["bytes_per_device"]["alias"] == cache // 256
    assert multi["bytes_per_device"]["alias"] == cache // 512
    # every model rank's ids and dists gathered: 2 x [Q/16, 10] x 4 B
    assert recs[2]["collective_bytes"] == 2 * (4096 // 16) * 10 * 4
    assert recs[3]["collective_bytes"] == 2 * (4096 // 32) * 10 * 4


if __name__ == "__main__" and sys.argv[1:2] == ["jax-dryrun"]:
    _jax_side(sys.argv[2])

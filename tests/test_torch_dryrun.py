"""The port's dry-run and ``analysis/`` on the CPU.

* An 8-rank fake world (4 × 2 mesh, in a subprocess: a fake process group
  must not become this process's world) traces one train step, a prefill
  and a decode of the five reduced architectures of
  ``tests/test_dryrun_small.py`` on fake ``DTensor``s: FLOPs > 0 and at
  least one collective in each train step (that test's assertions); the
  counts are a rank's own (a product over a sharded dim counts its local
  share); the argument bytes are the rules' local shard sizes.
* ``analysis/trace.py``: the FLOPs of a product, views left out of the
  traffic, collectives counted with their operand bytes.
* ``analysis/roofline.py``: ``model_flops`` against the reference's for
  every arch × shape, and ``roofline_terms`` against hand arithmetic with
  the H100 constants.
* ``analysis/report.py``: tables and the re-analysis from saved cells.
"""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

from repro.analysis.roofline import model_flops as jmodel_flops  # noqa: E402
from repro.config import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro_torch.analysis import report  # noqa: E402
from repro_torch.analysis.roofline import HW, model_flops, roofline_terms  # noqa: E402
from repro_torch.analysis.trace import (  # noqa: E402
    collective_summary, parse_collectives, trace_step)
from repro_torch.config import SHAPES  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
ARCHS = ["qwen3_8b", "granite_moe_1b", "mamba2_370m", "recurrentgemma_9b",
         "whisper_base"]

SMALL_WORLD = textwrap.dedent("""
    import sys, json
    sys.path.insert(0, %r)
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.analysis.trace import trace_step
    from repro_torch.config import MeshConfig, RunConfig, ShapeConfig, reduced
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.mesh import make_mesh
    from repro_torch.models.base import leaves_with_paths
    from repro_torch.optim import build_optimizer
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    D.start_fake_world(8)
    mesh = make_mesh((4, 2), ("data", "model"), device="cpu")
    out = {}
    for arch in %r:
        extra = {}
        if arch == "mamba2_370m":   # keep ssm dims consistent
            extra = dict(ssm_heads=4, ssm_head_dim=32, ssm_state=16)
        cfg = reduced(get_config(arch), d_model=64, n_heads=4, n_kv_heads=2,
                      head_dim=16, vocab_size=256, **extra)
        for kind in ("train", "prefill", "decode"):
            shape = ShapeConfig("t", 64, 8, kind)
            run = RunConfig(model=cfg, shape=shape,
                            mesh=MeshConfig((4, 2), ("data", "model")),
                            micro_batches=2 if kind == "train" else 1,
                            max_cache_len=64)
            rules = D.cell_rules(cfg, shape, mesh)
            fake = D.fake_mode()
            model, args = D.cell_args(run, mesh, rules, fake)
            # the argument bytes against the rules' local shard sizes
            specs = {"params": model.param_specs()}
            if kind == "train":
                specs["opt_state"] = build_optimizer(
                    run.optimizer).state_specs(model.param_specs())
            else:
                specs["cache"] = model.cache_specs(8, 64)
            want = 0
            for _, s in leaves_with_paths(specs):
                local, _ = compute_local_shape_and_global_offset(
                    s.shape, mesh, rules.placements(mesh, *s.logical))
                n = 1
                for x in local:
                    n *= x
                want += n * torch.empty((), dtype={
                    "float32": torch.float32, "bfloat16": torch.bfloat16,
                    "int8": torch.int8}[s.dtype]).element_size()
            got = sum(D.local_bytes(v) for k, v in args.items()
                      if k != "inputs")
            st = D.trace_cell(run, mesh, rules, fake)
            out[f"{arch}/{kind}"] = dict(
                flops=st.flops, coll_count=st.coll_count,
                coll_bytes=st.coll_operand_bytes, traffic=st.traffic_bytes,
                arg_bytes=got, want_arg_bytes=want)
    # a product over a sharded dim: each rank counts its own share
    fake = D.fake_mode()
    with fake:
        a = distribute_tensor(torch.randn(256, 1024), mesh,
                              [Shard(0), Replicate()])
        w = distribute_tensor(torch.randn(1024, 4096), mesh,
                              [Replicate(), Shard(1)])
    _, st = trace_step(lambda: a @ w, fake_mode=fake)
    out["mm"] = dict(flops=st.flops, coll_count=st.coll_count)
    print(json.dumps(out))
""") % (SRC, ARCHS)


@pytest.fixture(scope="module")
def small_world():
    r = subprocess.run([sys.executable, "-c", SMALL_WORLD],
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ARCHS)
def test_small_fake_world_train_step(small_world, arch):
    got = small_world[f"{arch}/train"]
    assert got["flops"] > 0
    assert got["coll_count"] > 0, "sharded train step must communicate"
    assert got["arg_bytes"] == got["want_arg_bytes"]


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_small_fake_world_serving_steps(small_world, arch, kind):
    got = small_world[f"{arch}/{kind}"]
    assert got["flops"] > 0 and got["traffic"] > 0
    assert got["arg_bytes"] == got["want_arg_bytes"]
    # decode moves one token a row: far fewer FLOPs than a 64-token prefill
    if kind == "decode":
        assert got["flops"] < small_world[f"{arch}/prefill"]["flops"]


def test_trace_counts_local_shares(small_world):
    """(256 × 1024) @ (1024 × 4096) over a 4 × 2 mesh, the rows over data
    and the columns over model: a rank multiplies 64 rows by 2048 columns,
    without a collective."""
    assert small_world["mm"] == {"flops": 2 * 64 * 1024 * 2048,
                                 "coll_count": 0}


def test_trace_counts_products_and_skips_views():
    a, b = torch.randn(8, 16), torch.randn(16, 32)
    out, st = trace_step(lambda: (a @ b).t().unsqueeze(0))
    assert out.shape == (1, 32, 8)
    assert st.flops == 2 * 8 * 16 * 32
    assert st.ops == 1                      # the product; t/reshape are views
    assert st.traffic_bytes == (8 * 16 + 16 * 32 + 8 * 32) * 4
    assert st.flops_by_op == {"mm": st.flops}
    assert parse_collectives(st) == []
    assert collective_summary(st)["count"] == 0


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if a != "paper_sfa"])
def test_model_flops_match_the_reference(arch, shape):
    assert model_flops(get_config(arch), SHAPES[shape]) == jmodel_flops(
        jget_config(arch), JSHAPES[shape])


def test_roofline_terms_by_hand():
    cfg = get_config("qwen3_8b")
    r = roofline_terms(cfg, SHAPES["train_4k"], per_device_flops=1e12,
                       per_device_bytes=1e9, per_device_coll_bytes=1e9,
                       n_chips=256)
    hw = HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw) == (989e12, 3.35e12, 50e9)
    assert r.compute_s == pytest.approx(1e12 / 989e12)
    assert r.memory_s == pytest.approx(1e9 / 3.35e12)
    assert r.collective_s == pytest.approx(1e9 / 50e9)
    assert r.dominant == "collective"
    mf = 6 * cfg.active_param_count() * 256 * 4096
    assert r.model_flops == mf
    assert r.useful_ratio == pytest.approx(mf / (1e12 * 256))
    assert r.to_json()["hlo_flops_per_device"] == 1e12
    d = roofline_terms(cfg, SHAPES["decode_32k"], per_device_flops=1e9,
                       per_device_bytes=1e12, per_device_coll_bytes=0,
                       n_chips=256)
    assert d.dominant == "memory"
    assert d.model_flops == 2 * cfg.active_param_count() * 128


def _cell(arch, shape, **kw) -> dict:
    return {"arch": arch, "shape": shape, "status": "ok", "n_devices": 256,
            "memory": {"argument_gb": 1.5, "fits_80gb": True},
            "trace_stats": {"flops": 1e12, "traffic_bytes": 1e9,
                            "coll_operand_bytes": 2e9, "coll_count": 7,
                            "per_op": {"all-gather": {"count": 7}}},
            "roofline": {}, **kw}


def test_report_reanalyzes_and_renders(tmp_path, capsys):
    (tmp_path / "qwen3_8b__train_4k__pod.json").write_text(
        json.dumps(_cell("qwen3_8b", "train_4k")))
    (tmp_path / "qwen3_8b__long_500k__pod.json").write_text(json.dumps(
        {"arch": "qwen3_8b", "shape": "long_500k", "status": "skipped"}))
    (tmp_path / "qwen3_8b__train_4k__multipod.json").write_text(
        json.dumps(_cell("qwen3_8b", "train_4k")))
    report.reanalyze(tmp_path)
    d = json.loads((tmp_path / "qwen3_8b__train_4k__pod.json").read_text())
    assert d["roofline"]["collective_s"] == pytest.approx(2e9 / 50e9)
    assert d["roofline"]["dominant"] == "collective"
    table = report.tables(tmp_path)
    assert table.splitlines()[0] == "| arch | long_500k | train_4k |"
    assert table.splitlines()[2].startswith(
        "| qwen3_8b | skipped | 1.50 GB; collective: c 0.00101 / m 0.000299"
        " / x 0.04 s; 1.00e+12 FLOPs, 7 coll. 2 GB |")
    assert "all-gather×7" in report.multipod_table(tmp_path)

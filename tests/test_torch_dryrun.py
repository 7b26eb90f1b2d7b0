"""The port's dry-run and ``analysis/`` on the CPU.

* An 8-rank fake world (4 × 2 mesh, in a subprocess: a fake process group
  must not become this process's world) traces one train step, a prefill
  and a decode of the five reduced architectures of
  ``tests/test_dryrun_small.py`` and of yi_34b under its own rules on
  fake ``DTensor``s: FLOPs > 0 and at
  least one collective in each train step (that test's assertions); the
  counts are a rank's own (a product over a sharded dim counts its local
  share); the argument bytes are the rules' local shard sizes.
* ``analysis/trace.py``: the FLOPs of a product, views left out of the
  traffic, collectives counted with their operand bytes.
* ``analysis/roofline.py``: ``model_flops`` against the reference's for
  every arch × shape, and ``roofline_terms`` against hand arithmetic with
  the H100 constants.
* ``analysis/report.py``: tables and the re-analysis from saved cells.
* Trace order, depth and live bytes: a trace counts the same whatever
  the process traced before; every count at four groups equals what two
  and three extrapolate to (the high water site by site); run_cell writes
  no negative count; the live-bytes high water by hand on plain fake
  tensors; ``sharding.rules.product``'s placements; the one-device cell.
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
         "whisper_base", "yi_34b"]

SMALL_WORLD = textwrap.dedent("""
    import dataclasses, sys, json
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
        base = reduced(get_config(arch), d_model=64, n_heads=4,
                       n_kv_heads=2, head_dim=16, vocab_size=256, **extra)
        for kind in ("train", "prefill", "decode"):
            cfg = base
            if arch == "yi_34b":    # its own rules, as get_run gives them
                yi = get_config(arch)
                cfg = dataclasses.replace(base, sharding_overrides=(
                    yi.sharding_overrides if kind == "train"
                    else yi.serving_overrides))
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


# --------------------------------------------------------------------------
# Trace order, depth and the step's live bytes
# --------------------------------------------------------------------------

#: Cells held to their extrapolation: (arch, kind) at reduced width, under
#: the arch's own rules (yi_34b's split the stream's sequence).
DEPTH_CELLS = [("yi_34b", "decode"), ("yi_34b", "train"),
               ("qwen3_8b", "train"), ("granite_moe_1b", "prefill"),
               ("whisper_base", "train")]

DEPTH_WORLD = textwrap.dedent("""
    import dataclasses, sys, json
    from pathlib import Path
    sys.path.insert(0, %r)
    from repro_torch.config import MeshConfig, RunConfig, ShapeConfig, reduced
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.mesh import make_mesh

    D.start_fake_world(8)
    mesh = make_mesh((4, 2), ("data", "model"), device="cpu")

    def cell(arch, kind, groups):
        base = get_config(arch)
        rules = {}
        if arch == "yi_34b":
            rules = (base.sharding_overrides if kind == "train"
                     else base.serving_overrides)
        cfg = reduced(base, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                      vocab_size=256, sharding_overrides=rules)
        cfg = D.with_groups(cfg, groups)
        shape = ShapeConfig("t", 64, 8, kind)
        run = RunConfig(model=cfg, shape=shape,
                        mesh=MeshConfig((4, 2), ("data", "model")),
                        micro_batches=2 if kind == "train" else 1,
                        max_cache_len=64)
        return run, D.cell_rules(cfg, shape, mesh)

    out = {}
    fake = D.fake_mode()
    # the fault's smallest input: this process's first trace, then again
    run, rules = cell("yi_34b", "decode", 1)
    out["first"], out["second"] = (
        D.trace_cell(run, mesh, rules, fake).to_json() for _ in range(2))
    for arch, kind in %r:
        run, rules = cell(arch, kind, 4)
        ext, depths = D.cell_stats(run, mesh, rules, fake)
        traced = D.trace_cell(run, mesh, rules, fake).to_json()
        out[f"{arch}/{kind}"] = dict(extrapolated=ext, traced=traced,
                                     depths=depths)
    # products on shards: the placements of the results
    from torch.distributed.tensor import Replicate as R, Shard as S
    from repro_torch.models.base import fake_dtensor
    from repro_torch.sharding.rules import product
    import torch

    def fd(shape, *place):
        return fake_dtensor(shape, torch.float32, mesh, list(place), fake)

    cases = {
        # yi's stream (rows over data, sequence over model) into the mlp
        "seq_mlp": product("bsd,df->bsf", fd((8, 16, 64), S(0), S(1)),
                           fd((64, 128), R(), S(1))),
        # its down-projection: a partial sum over model
        "down": product("bsf,fd->bsd", fd((8, 16, 128), S(0), S(2)),
                        fd((128, 64), R(), S(0))),
        # yi's serving q projection: the head_dim over model
        "head_dim_q": product("bsd,dhk->bshk", fd((8, 16, 64), S(0), R()),
                              fd((64, 4, 16), R(), S(2))),
        # its output projection: the whole heads sliced, a partial sum
        "head_dim_o": product("bshk,hkd->bsd", fd((8, 16, 4, 16), S(0), R()),
                              fd((4, 16, 64), R(), S(1))),
        # the heads over model (the default rules): no gather
        "heads_q": product("bsd,dhk->bshk", fd((8, 16, 64), S(0), R()),
                           fd((64, 4, 16), R(), S(1))),
    }
    # the loss and its gradient on logits split over rows and the vocab
    from repro_torch.analysis.trace import trace_step
    from repro_torch.models.layers import cross_entropy

    logits = fd((8, 64, 256), S(0), S(2)).requires_grad_()
    labels = fake_dtensor((8, 64), torch.int32, mesh, [S(0), R()], fake)
    _, st = trace_step(lambda lg, lb: torch.autograd.grad(
        cross_entropy(lg, lb), [lg])[0], logits, labels, fake_mode=fake)
    out["loss_peak"] = st.peak_temp_bytes
    # the lookup of a micro-batch's replicated tokens (8 x 64 of 256 ids)
    from repro_torch.models.layers import embed
    from repro_torch.sharding.rules import Rules

    ecfg = reduced(get_config("qwen3_8b"), d_model=64, vocab_size=256)
    table = fd((256, 64), R(), S(0))
    tokens = fake_dtensor((8, 64), torch.int32, mesh, [R(), R()], fake)
    _, st = trace_step(lambda t, x: embed(t, x, ecfg, Rules()), table,
                       tokens, fake_mode=fake)
    out["lookup_peak"] = st.peak_temp_bytes
    out["products"] = {k: dict(placements=str(tuple(v.placements)),
                               shape=list(v.shape),
                               local=list(v.to_local().shape))
                       for k, v in cases.items()}
    # run_cell's JSON, the cell built on this small mesh
    run, rules = cell("yi_34b", "decode", 4)
    D.build_cell = lambda *a, **k: (run, mesh, rules, D.fake_mode(),
                                    {"arch": "yi_34b", "shape": "t",
                                     "n_devices": 8, "kind": "decode"})
    out["cell"] = D.run_cell("yi_34b", "decode_32k", False, Path(sys.argv[1]))
    print(json.dumps(out))
""") % (SRC, DEPTH_CELLS)


@pytest.fixture(scope="module")
def depth_world(tmp_path_factory):
    r = subprocess.run([sys.executable, "-c", DEPTH_WORLD,
                        str(tmp_path_factory.mktemp("cells"))],
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_a_trace_does_not_depend_on_the_traces_before_it(depth_world):
    """yi_34b's decode traced twice in one process: the first trace counts
    what the second does (it counted DTensor's first-time bookkeeping)."""
    assert depth_world["first"] == depth_world["second"]
    assert depth_world["first"]["ops"] > 0


def _numbers(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _numbers(v, f"{path}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _numbers(v, f"{path}{i}/")
    elif isinstance(tree, (int, float)) and not isinstance(tree, bool):
        yield path, tree


def test_run_cell_writes_no_negative_count(depth_world):
    cell = depth_world["cell"]
    assert cell["status"] == "ok" and cell["traced_groups"] == [2, 3]
    neg = [(p, v) for p, v in _numbers(cell) if v < 0]
    assert not neg
    m = cell["memory"]
    assert m["temp_gb"] == cell["trace_stats"]["peak_temp_bytes"] / 1e9 > 0
    assert m["fits_80gb"] == (m["argument_gb"] + m["temp_gb"] < 80)
    assert "peak_by_site" not in cell["trace_stats"]


@pytest.mark.parametrize("arch,kind", DEPTH_CELLS)
def test_four_groups_equal_their_extrapolation(depth_world, arch, kind):
    """Every count at four groups, traced, equals what two and three
    extrapolate to: the high water of live bytes too (site by site)."""
    got = depth_world[f"{arch}/{kind}"]
    assert got["depths"] == [2, 3]
    ext, traced = got["extrapolated"], got["traced"]
    for k in ("ops", "flops", "traffic_bytes", "coll_count",
              "coll_operand_bytes", "peak_temp_bytes"):
        assert ext[k] == traced[k], (k, ext[k], traced[k])
    assert traced["peak_temp_bytes"] > 0


def test_affine_refuses_a_negative_count():
    from repro_torch.launch.dryrun import _affine

    assert _affine({"a": 5, "b": {"c": 1}}, {"a": 7, "b": {"c": 1}}, 10,
                   2) == {"a": 21, "b": {"c": 1}}
    with pytest.raises(ValueError, match="b/c"):
        _affine({"a": 1, "b": {"c": 9}}, {"a": 1, "b": {"c": 4}}, 10, 2)


def test_peak_temp_bytes_by_hand():
    """A chain on plain fake tensors that makes, frees and keeps known
    tensors: views, in-place writes and the argument count nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    fake = FakeTensorMode()
    with fake:
        a = torch.empty(1000)                       # the argument: 4,000 B

    def step(a):
        b = a * 2                                   # 4,000 live
        c = b.view(10, 100)                         # a view: 4,000
        d = c + 1                                   # 8,000
        del b, c                                    # 4,000
        a.mul_(3)                                   # in place: 4,000
        e = torch.ops.aten._unsafe_view(d, (4, 250))  # an alias: 4,000
        f = torch.empty(500)                        # 6,000
        f.add_(1)                                   # in place: 6,000
        del d, e                                    # 2,000
        g = f.repeat(5)                             # 12,000
        del f                                       # 10,000
        return g + 1                                # 20,000: the high water
    with fake:
        out, st = trace_step(step, a, fake_mode=fake)
    assert out.shape == (2500,)
    assert st.peak_temp_bytes == 20000
    assert st.ops == 6                              # mul add mul_ add_ repeat add


def test_peak_temp_bytes_counts_what_autograd_saves():
    """``tanh(x * w).sum()`` and its gradient in ``w``, 256 f32 each: the
    product (1,024 B) lives until ``tanh`` has run; ``tanh`` saves its
    output (1,024) for the backward, which frees it once
    ``tanh_backward`` has used it; beside the loss and its seed (4 each)
    at most two 1,024-byte tensors live at once."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    fake = FakeTensorMode()
    with fake:
        x = torch.empty(256)
        w = torch.empty(256, requires_grad=True)

    def step(x, w):
        loss = torch.tanh(x * w).sum()      # 2,048, then 1,024 + 4
        (g,) = torch.autograd.grad(loss, [w])   # 2,048 + 8 at most
        return g
    with fake:
        g, st = trace_step(step, x, w, fake_mode=fake)
    assert g.shape == (256,)
    assert st.peak_temp_bytes == 2 * 1024 + 4 + 4


#: The products of the LM layers, with their operands' shapes.
PRODUCTS = [("bsd,df->bsf", (2, 3, 4), (4, 5)),
            ("bsd,vd->bsv", (2, 3, 4), (5, 4)),
            ("bsd,dhk->bshk", (2, 3, 4), (4, 5, 6)),
            ("bshk,hkd->bsd", (2, 3, 5, 6), (5, 6, 4))]


@pytest.mark.parametrize("eq,xs,ws", PRODUCTS)
def test_product_on_plain_tensors_is_its_equation(eq, xs, ws):
    """``product`` runs the einsum its equation states as one matrix
    product, whichever side of the weight holds the contracted dims."""
    from repro_torch.sharding.rules import product

    g = torch.Generator().manual_seed(0)
    x = torch.randn(xs, generator=g, dtype=torch.float64)
    w = torch.randn(ws, generator=g, dtype=torch.float64)
    y, y2 = product(eq, x, w, 2 * w)
    want = torch.einsum(eq, x, w)
    assert y.shape == want.shape
    assert torch.allclose(y, want, rtol=1e-12, atol=1e-12)
    assert torch.allclose(y2, 2 * want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("eq", ["bsd,df->bfs", "bds,df->bsf",
                                "bshk,khd->bsd", "bsd,dv->bsvd"])
def test_product_refuses_what_is_not_one_matrix_product(eq):
    from repro_torch.sharding.rules import _matmul

    with pytest.raises(ValueError, match="not one matrix product"):
        _matmul(eq)


def test_products_run_on_shards_with_stated_placements(depth_world):
    """``sharding.rules.product``: a sequence-sharded activation is
    gathered before a weight split over ``model`` (Megatron's sequence
    parallelism), a contracted split gives a partial sum, a kept split
    stays a split of the result; every result has the global shape."""
    got = depth_world["products"]
    want = {
        "seq_mlp": ("(Shard(dim=0), Shard(dim=2))", [8, 16, 128], [2, 16, 64]),
        "down": ("(Shard(dim=0), Partial(sum))", [8, 16, 64], [2, 16, 64]),
        "head_dim_q": ("(Shard(dim=0), Shard(dim=3))", [8, 16, 4, 16],
                       [2, 16, 4, 8]),
        "head_dim_o": ("(Shard(dim=0), Partial(sum))", [8, 16, 64],
                       [2, 16, 64]),
        "heads_q": ("(Shard(dim=0), Shard(dim=2))", [8, 16, 4, 16],
                    [2, 16, 2, 16]),
    }
    assert {k: (v["placements"], v["shape"], v["local"])
            for k, v in got.items()} == want


def test_one_device_cell_counts_the_step_it_traces(tmp_path, monkeypatch):
    """``--one-device --global-batch``: no mesh; the arguments are the
    whole tree's bytes; a model deeper than three groups is traced at two
    and three; the temporaries are counted."""
    from repro_torch import configs
    from repro_torch.config import ShapeConfig, reduced
    from repro_torch.launch import dryrun as D
    from repro_torch.models.base import param_bytes
    from repro_torch.models.model import build_model
    from repro_torch.optim import build_optimizer

    real = configs.get_config
    monkeypatch.setattr(configs, "get_config", lambda a: reduced(
        real(a), n_layers=4) if a == "qwen3_8b" else real(a))
    monkeypatch.setitem(configs.SHAPES, "train_4k",
                        ShapeConfig("train_4k", 32, 16, "train"))
    cell = D.run_cell("qwen3_8b", "train_4k", False, tmp_path,
                      one_device=True, global_batch=4)
    assert (tmp_path / "qwen3_8b__train_4k__one.json").exists()
    run = configs.get_run("qwen3_8b", "train_4k")
    specs = build_model(run.model).param_specs()
    want = {"params": param_bytes(specs),
            "opt_state": param_bytes(build_optimizer(
                run.optimizer).state_specs(specs)),
            "inputs": 2 * 4 * 32 * 4}
    assert cell["memory"]["argument_bytes"] == want
    assert (cell["n_devices"], cell["global_batch"]) == (1, 4)
    assert cell["traced_groups"] == [2, 3] and cell["groups"] == 4
    assert cell["trace_stats"]["coll_count"] == 0
    assert cell["memory"]["temp_gb"] > 0


def test_report_counts_the_temporaries_in_the_fit():
    cell = _cell("qwen3_8b", "train_4k")
    cell["memory"] = {"argument_gb": 1.5, "temp_gb": 79.0,
                      "fits_80gb": False}
    cell["roofline"] = {"dominant": "memory", "compute_s": 1.0,
                        "memory_s": 2.0, "collective_s": 0.5}
    assert report._cell(cell).startswith("1.50 GB + 79.00 GB temp (NO); ")


def test_the_loss_on_split_logits_stays_on_each_rank(depth_world):
    """The cross-entropy on logits split over rows and the vocab (8 x 64 x
    256 f32 on the 4 x 2 mesh: a rank's shard 2 x 64 x 128, 64 KiB): its
    forward and gradient hold a few shards' bytes at once. DTensor's own
    strategies gathered the vocab for ``logsumexp`` and filled a tensor of
    the whole batch's logits (512 KiB on every rank) in the gather's
    backward."""
    shard = 2 * 64 * 128 * 4
    assert 0 < depth_world["loss_peak"] <= 4 * shard


def test_a_replicated_micro_batch_is_looked_up_by_rows(depth_world):
    """A micro-batch sliced from a row-split batch comes replicated: its
    lookup (8 x 64 tokens from an f32 table of width 64) takes each rank's
    2 rows, a few of their 32 KiB at once, not the whole micro-batch's
    128 KiB."""
    rows = 2 * 64 * 64 * 4
    assert 0 < depth_world["lookup_peak"] <= 4 * rows

"""Every public name of the reference's ported packages has a twin in the
port: each name in the ``__all__`` of ``repro.core``,
``repro.construction``, ``repro.engine``, ``repro.speculative``,
``repro.scanservice``, ``repro.serve``, ``repro.sharding`` and
``repro.analysis`` exists in the matching ``repro_torch`` package (a
submodule name as a submodule); and each public name a module of the LM
half defines (its functions, classes, constants, and ``Model``'s methods)
exists in its twin module. ``repro.obs`` has no ``__all__``.
"""

import importlib
import importlib.util
import types

import pytest

pytest.importorskip("torch")

#: Deliberate exceptions: the reference's AOT round-compile cache has no
#: twin (a PyTorch round keeps no compiled executable).
EXCEPTIONS = {
    "construction": {"RoundCompileCache", "RoundCacheInfo",
                     "round_compile_cache"},
}
#: ``analysis.hlo`` parses XLA's HLO text, which PyTorch does not have: its
#: counterpart is ``analysis.trace`` (a dispatch-mode record of the step),
#: which takes its public names.
COUNTERPARTS = {"analysis": {"hlo": "trace"}}

#: The LM half's modules, and the names of each that are left out. Left
#: out for good: ``optim.api._layerwise`` (a ``lax.map`` over the layer
#: axis behind a flag that is off by default; ``update`` never calls it).
LEFT_OUT = "left out: behind a flag that is off by default, never called"
LM_MODULES = {
    "config": {},
    "configs": {},
    "sharding.rules": {},
    "models.base": {},
    "models.layers": {},
    "models.attention": {},
    "models.moe": {},
    "models.ssm": {},
    "models.rglru": {},
    "models.transformer": {},
    "models.whisper": {},
    "models.model": {},
    "serve.steps": {},
    "serve.engine": {},
    "launch.serve": {},
    # the training slice
    "optim.api": {"_layerwise": LEFT_OUT},
    "optim.schedule": {},
    "train.steps": {},
    "train.trainer": {},
    "checkpoint.manager": {},
    "data.pipeline": {},
    "data.protein": {},
    "launch.train": {},
    # the sharded LM path and the dry-run
    "launch.mesh": {},
    "launch.dryrun": {},
    "analysis.roofline": {},
    "analysis.report": {},
}
#: ``Model``'s methods that are left out: none.
MODEL_WAITING: dict = {}


@pytest.mark.parametrize("package", ["core", "construction", "engine",
                                     "speculative", "scanservice", "serve",
                                     "sharding", "analysis"])
def test_reference_names_exist_in_the_port(package):
    ref = importlib.import_module(f"repro.{package}")
    port = importlib.import_module(f"repro_torch.{package}")
    missing = []
    for name in ref.__all__:
        if name in EXCEPTIONS.get(package, ()):
            continue
        if isinstance(getattr(ref, name), types.ModuleType):
            name = COUNTERPARTS.get(package, {}).get(name, name)
            if importlib.util.find_spec(f"repro_torch.{package}.{name}") \
                    is None:
                missing.append(name)
        elif not hasattr(port, name):
            missing.append(name)
    assert not missing, f"repro_torch.{package} lacks {missing}"
    # the exceptions are still exceptions: a twin means the list is stale
    stale = [n for n in EXCEPTIONS.get(package, ()) if hasattr(port, n)]
    assert not stale, stale


def _defined_names(mod) -> set:
    """Public names ``mod`` defines: functions and classes whose module it
    is, and constants (values with no ``__module__``)."""
    out = set()
    for name, obj in vars(mod).items():
        if name.startswith("_") or isinstance(obj, types.ModuleType):
            continue
        owner = getattr(obj, "__module__", None)
        if owner is None or owner == mod.__name__:
            out.add(name)
    return out


@pytest.mark.parametrize("module", sorted(LM_MODULES))
def test_lm_module_names_exist_in_the_port(module):
    ref = importlib.import_module(f"repro.{module}")
    port = importlib.import_module(f"repro_torch.{module}")
    waiting = LM_MODULES[module]
    assert set(waiting) <= set(vars(ref)), sorted(set(waiting) - set(vars(ref)))
    missing = sorted(n for n in _defined_names(ref) - set(waiting)
                     if not hasattr(port, n))
    assert not missing, f"repro_torch.{module} lacks {missing}"
    stale = [n for n in waiting if hasattr(port, n)]
    assert not stale, stale


def test_hlo_names_exist_in_its_counterpart():
    """``analysis.hlo``'s public names (the ones its package exports and
    the tests use) exist in ``analysis.trace``, taking a trace record."""
    import repro.analysis as ja
    from repro_torch.analysis import trace

    hlo_names = {n for n in ja.__all__
                 if getattr(ja, n).__module__ == "repro.analysis.hlo"}
    assert hlo_names == {"collective_summary", "parse_collectives"}
    assert not [n for n in hlo_names if not hasattr(trace, n)]
    assert importlib.util.find_spec("repro_torch.analysis.hlo") is None


def test_model_methods_and_arch_configs_exist_in_the_port():
    from repro.configs import ARCH_IDS
    from repro.models.model import Model as JModel
    from repro_torch.models.model import Model

    public = {n for n in vars(JModel) if not n.startswith("_")}
    missing = sorted(n for n in public - set(MODEL_WAITING)
                     if not hasattr(Model, n))
    assert not missing, f"repro_torch Model lacks {missing}"
    assert not [n for n in MODEL_WAITING if hasattr(Model, n)]
    for arch in ARCH_IDS:
        assert importlib.util.find_spec(f"repro_torch.configs.{arch}"), arch


def test_lazy_construction_names_and_shims():
    import repro_torch.construction as C
    import repro_torch.core as core
    from repro_torch.core import sfa, sfa_jax

    for name in sfa.__all__:
        assert getattr(core, name) is getattr(C, name) is getattr(sfa, name)
    assert sfa_jax.construct_sfa_jax is C.construct_sfa_jax
    with pytest.raises(AttributeError):
        core.no_such_name


def test_construct_sfa_jax_is_the_one_pattern_bank():
    from repro.construction import construct_sfa_jax as jconstruct_sfa_jax
    from repro.core.dfa import random_dfa as jrandom_dfa
    from repro_torch.construction import construct_sfa_jax
    from repro_torch.core.dfa import random_dfa

    import numpy as np

    got = construct_sfa_jax(random_dfa(5, 4, seed=2), tile=32, device="cpu")
    want = jconstruct_sfa_jax(jrandom_dfa(5, 4, seed=2), tile=32)
    assert got.stats.engine == want.stats.engine == "jax"
    assert np.array_equal(got.delta, want.delta)
    assert np.array_equal(got.mappings, want.mappings)
    assert np.array_equal(got.fingerprints, want.fingerprints)


def test_bucket_by_size_matches_the_reference():
    from repro.core.dfa import random_dfa as jrandom_dfa
    from repro.core.multipattern import bucket_by_size as jbucket
    from repro_torch.core.dfa import random_dfa
    from repro_torch.core.multipattern import bucket_by_size

    import numpy as np

    sizes = (2, 3, 9, 17, 5, 40)
    got = bucket_by_size([random_dfa(n, 4, seed=n) for n in sizes],
                         edges=(4, 16, 64))
    want = jbucket([jrandom_dfa(n, 4, seed=n) for n in sizes],
                   edges=(4, 16, 64))
    assert [b.ids for b in got] == [b.ids for b in want]
    for a, b in zip(got, want):
        assert np.array_equal(a.tables, b.tables)
    with pytest.raises(ValueError, match="pattern"):
        bucket_by_size([random_dfa(70, 4, seed=1)], edges=(4, 16, 64))

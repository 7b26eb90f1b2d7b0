"""Every public name of the reference's paper-half packages has a twin in
the port: each name in the ``__all__`` of ``repro.core``,
``repro.construction``, ``repro.engine``, ``repro.speculative`` and
``repro.scanservice`` exists in the matching ``repro_torch`` package (a
submodule name as a submodule). ``repro.obs`` has no ``__all__``.
"""

import importlib
import importlib.util
import types

import pytest

pytest.importorskip("torch")

#: Deliberate exceptions: the reference's AOT round-compile cache has no
#: twin (a PyTorch round keeps no compiled executable), and the LM half's
#: monoids come with the rest of the LM half.
EXCEPTIONS = {
    "construction": {"RoundCompileCache", "RoundCacheInfo",
                     "round_compile_cache"},
    "core": {"affine_monoid", "softmax_monoid"},
}


@pytest.mark.parametrize("package", ["core", "construction", "engine",
                                     "speculative", "scanservice"])
def test_reference_names_exist_in_the_port(package):
    ref = importlib.import_module(f"repro.{package}")
    port = importlib.import_module(f"repro_torch.{package}")
    missing = []
    for name in ref.__all__:
        if name in EXCEPTIONS.get(package, ()):
            continue
        if isinstance(getattr(ref, name), types.ModuleType):
            if importlib.util.find_spec(f"repro_torch.{package}.{name}") \
                    is None:
                missing.append(name)
        elif not hasattr(port, name):
            missing.append(name)
    assert not missing, f"repro_torch.{package} lacks {missing}"
    # the exceptions are still exceptions: a twin means the list is stale
    stale = [n for n in EXCEPTIONS.get(package, ()) if hasattr(port, n)]
    assert not stale, stale


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

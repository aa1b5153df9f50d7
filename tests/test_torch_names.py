"""The port's public names against ``heat_tpu``'s: ``dir()`` of the two
packages and of every subpackage of ``heat_tpu``, diffed.

A name that ``heat_tpu`` defines (its own objects, not what a module
imports from JAX, NumPy or the standard library) and the port lacks must
stand in ``ABSENT`` with the ROADMAP.md entry that takes it: a Queue 1
item, or a port decision under "Not faults". A name in ``ABSENT`` that the
port now has must leave the list, so that the list stays true. Plain
submodules are left out of the diff (what a package's ``dir()`` shows of
them depends on which tests imported them first); their public names are
in the package's namespace, and subpackages are diffed themselves.
"""

import importlib
import os
import pkgutil
import types

import pytest

import heat_tpu as jht
import heat_tpu_torch as ht

# ROADMAP.md Queue 1 items and "Not faults", by reason
_JIT = "item 12 (b): core/jit.py, ht.jit"
_SERVICE = "item 13: service layers"
_COMPLEX = "Not faults: native complex, no complex platform policy"
_COMM = "Not faults: the communicator is TorchCommunication (MPICommunication names it)"
_PHYS = "Not faults: the port's resplit_local/reshape_local"

ABSENT = {
    "heat_tpu": {
        "MeshCommunication": _COMM,
        "check_complex_platform": _COMPLEX, "complex_mode": _COMPLEX, "supports_complex": _COMPLEX,
        "use_complex": _COMPLEX, "jit": _JIT, "solve_endpoint": _SERVICE, "serving": _SERVICE, "observability": _SERVICE, "resilience": _SERVICE,
        "analysis": "item 14: analysis",
    },
    "heat_tpu.core": {
        "MeshCommunication": _COMM,
        "check_complex_platform": _COMPLEX, "complex_mode": _COMPLEX, "supports_complex": _COMPLEX,
        "use_complex": _COMPLEX, "jit": _JIT, "solve_endpoint": _SERVICE,
    },
    "heat_tpu.core.linalg": {"solve_endpoint": _SERVICE},
    "heat_tpu.redistribution": {"resplit_phys": _PHYS, "reshape_phys": _PHYS},
}


def _subpackages(path, prefix: str) -> list:
    """The dotted names of the packages under ``path``, read from the
    directories (nothing is imported)."""
    out = []
    for info in pkgutil.iter_modules(path):
        if info.ispkg:
            name = prefix + info.name
            out += [name] + _subpackages([os.path.join(path[0], info.name)], name + ".")
    return out


# heat_tpu's subpackages, each with the port's counterpart or named absent above
PACKAGES = ["heat_tpu"] + sorted(_subpackages(jht.__path__, "heat_tpu."))


def _own(module, name: str) -> bool:
    """Whether ``module.name`` is heat_tpu's own object (not an import of
    JAX, NumPy, typing or the standard library) and not a plain submodule."""
    obj = getattr(module, name)
    if isinstance(obj, types.ModuleType):
        return obj.__name__.startswith("heat_tpu") and hasattr(obj, "__path__")
    origin = getattr(obj, "__module__", None)
    return origin is None or origin.startswith("heat_tpu")


def _public(module) -> set:
    return {n for n in dir(module) if not n.startswith("_")}


@pytest.mark.parametrize("package", PACKAGES)
def test_public_names_match_heat_tpu_but_the_allow_list(package):
    """Every public name of a ``heat_tpu`` package is in the port's
    counterpart, or stands in ``ABSENT`` with its ROADMAP entry; a
    subpackage the port lacks is itself a name absent from its parent."""
    parent, _, leaf = package.rpartition(".")
    try:
        mine = importlib.import_module("heat_tpu_torch" + package[len("heat_tpu"):])
    except ModuleNotFoundError:
        assert leaf in ABSENT.get(parent, {}), f"{package} has no port and no ROADMAP entry"
        return
    theirs = importlib.import_module(package)
    missing = {n for n in _public(theirs) - _public(mine) if _own(theirs, n)}
    allowed = ABSENT.get(package, {})
    assert missing <= set(allowed), f"{package}: names with no port and no ROADMAP entry: {sorted(missing - set(allowed))}"
    assert set(allowed) <= missing, f"{package}: ported now, drop from ABSENT: {sorted(set(allowed) - missing)}"


def test_every_allow_list_entry_names_a_roadmap_entry():
    for package, names in ABSENT.items():
        assert package in PACKAGES, package
        for name, why in names.items():
            assert why.startswith(("item ", "Not faults")), (package, name, why)


@pytest.mark.parametrize("name", ["block_sort", "pack_rows", "unpack_rows", "lane_fill"])
def test_kernel_entry_points_are_exported(name):
    module = "sort" if name == "block_sort" else "relayout"
    assert getattr(ht.kernels, name) is getattr(getattr(ht.kernels, module), name)


def test_small_names_behave_as_heat_tpus():
    """``MPI_SELF`` is a one-rank communicator whatever the world,
    ``MPICommunication`` names the communicator class, ``types.flexible``
    is an abstract base, ``use_x64`` reports the port's fixed 64-bit
    policy, ``version`` carries heat_tpu's version, and the planner's
    cache can be cleared."""
    assert (ht.MPI_SELF.size, ht.MPI_SELF.rank) == (1, 0) and ht.MPI_SELF.chunk((5, 3), 0)[1] == (5, 3)
    assert isinstance(ht.MPI_WORLD, ht.MPICommunication) and isinstance(ht.MPI_SELF, ht.MPICommunication)
    assert issubclass(ht.types.flexible, ht.types.datatype) and not issubclass(ht.float32, ht.types.flexible)
    assert ht.use_x64() is True and ht.use_x64(True) is True
    with pytest.raises(ValueError):
        ht.use_x64(False)
    assert ht.version.__version__ == ht.__version__ == jht.version.__version__
    ht.use_device("cpu")
    ht.arange(8, split=0).resplit(None)
    assert ht.redistribution.clear_plan_cache() >= 0 and ht.redistribution.clear_plan_cache() == 0
    assert ht.redistribution.planner_enabled() is True
    assert ht.redistribution.schedule_ir is ht.redistribution.schedule
    assert ht.redistribution.spec_mod is ht.redistribution.spec

"""The port's public names against the JAX package's, package by
package and module by module, with the deliberate omissions listed
below; and the names that carry behaviour (``POLICIES``,
``available_backends``, ``nominal_latency``, ``rail_subsets``,
``CompilationContext.master_states``) against the reference's results.
"""

import importlib
import inspect
import os
import types

import pytest

import repro.core as ref_core
import repro_torch.core as core
from repro.core.context import CompilationContext as RefContext
from repro.hw.dvfs import rail_subsets as ref_rail_subsets
from repro.hw.edge40nm import EDGE40NM_DEFAULT as REF_ACC
from repro.models.edge_cnn import edge_network as ref_network
from repro.perfmodel import characterize_network as ref_characterize
from repro.perfmodel.layer_costs import nominal_latency as ref_nominal
from repro_torch.core.context import CompilationContext
from repro_torch.core.policies import _REGISTRY
from repro_torch.hw.dvfs import rail_subsets, voltage_levels
from repro_torch.hw.edge40nm import EDGE40NM_DEFAULT as ACC
from repro_torch.models.edge_cnn import edge_network
from repro_torch.perfmodel import characterize_network
from repro_torch.perfmodel.layer_costs import nominal_latency

PACKAGES = ("core", "kernels", "hw", "perfmodel", "serve", "models",
            "service", "analysis", "calib", "data", "configs")
# the reference's ``train`` and ``launch`` have no __init__.py: compared
# module by module
MODULE_PACKAGES = PACKAGES + ("train", "launch")

# Names of the reference the port leaves out on purpose, by package or
# module.  Each entry must still be missing from the port: once it is
# ported, it leaves this list.
OMITTED = {
    # the scalar solver path (the host DP and its bisection) and the
    # thread-pool sweep's knobs: slower routes to the same schedules
    "core": {"dp_paths", "dp_best_path", "kbest_paths"},
    "core.lambda_dp": {"dp_paths", "dp_best_path", "kbest_paths"},
    "core.policies": {"sweep_workers", "stack_max_live"},
    # the numpy and JAX backends and their host restacking: the port has
    # one TorchBackend, with lane mirrors on the device
    "core.backend": {"NumpyBackend", "JaxBackend", "lane_bucket", "repad",
                     "stack_padded"},
    # the Pallas kernels; their CUDA counterparts live in
    # repro_torch.kernels.dp_sweep under their own names
    "kernels": {"dp_multi_stacked_pallas", "kbest_multi_stacked_pallas",
                "path_components_pallas"},
    # the reference's TPU chip model: its counterpart carries the card's
    # name (GpuChipModel, H100_SXM; RENAMED below)
    "hw": {"TpuChipModel", "TPU_V5E"},
    "hw.tpu": {"TpuChipModel"},
    # the reference's TPU adapter: its counterparts carry the card's name
    # (GpuLayerCost, build_gpu_problem; RENAMED below)
    "core.tpu_adapter": {"TpuLayerCost", "build_tpu_problem"},
    # the XLA HLO collective parser; its counterpart sums the port's own
    # logged collectives (repro_torch.launch._count.collective_totals)
    "launch.dryrun": {"parse_collective_bytes"},
    # the jnp attention oracles (the kernels' plain versions stand in)
    "models.layers": {"AttnChunks", "decode_attention_jnp",
                      "flash_attention_jnp"},
}


def _public(mod) -> set[str]:
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n, v in vars(mod).items()
                 if not n.startswith("_")
                 and not isinstance(v, types.ModuleType)]
    # submodules a package exposes lazily (``repro.analysis``)
    return set(names) | set(getattr(mod, "_SUBMODULES", ()))


def _defined(mod) -> set[str]:
    """Functions and classes a module defines itself."""
    return {n for n, v in vars(mod).items()
            if not n.startswith("_")
            and (inspect.isfunction(v) or inspect.isclass(v))
            and v.__module__ == mod.__name__}


def _port_modules(pkg: str) -> list[str]:
    root = os.path.dirname(importlib.import_module(
        f"repro_torch.{pkg}").__file__)
    out = []
    for name in sorted(os.listdir(root)):
        stem = name[:-3]
        if not name.endswith(".py") or stem == "__init__":
            continue
        # the reference's dry-run sets XLA_FLAGS (512 host devices) when
        # imported; this process keeps its own
        flags = os.environ.get("XLA_FLAGS")
        try:
            importlib.import_module(f"repro.{pkg}.{stem}")
        except ImportError:
            continue                 # the port's own module
        finally:
            if flags is None:
                os.environ.pop("XLA_FLAGS", None)
            else:
                os.environ["XLA_FLAGS"] = flags
        out.append(f"{pkg}.{stem}")
    return out


MODULES = [m for pkg in MODULE_PACKAGES for m in _port_modules(pkg)]

# reference modules whose port carries the card's name in place of the
# TPU's, with the names that change
RENAMED = {
    "core.tpu_adapter": ("core.gpu_adapter",
                         {"TpuLayerCost": "GpuLayerCost",
                          "build_tpu_problem": "build_gpu_problem"}),
    "hw.tpu": ("hw.gpu", {"TpuChipModel": "GpuChipModel"}),
}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_package_exports_match_the_reference(pkg):
    ref = _public(importlib.import_module(f"repro.{pkg}"))
    port = _public(importlib.import_module(f"repro_torch.{pkg}"))
    omitted = OMITTED.get(pkg, set())
    assert ref - port == omitted
    assert not omitted & port


@pytest.mark.parametrize("name", MODULES)
def test_module_definitions_match_the_reference(name):
    ref = _defined(importlib.import_module(f"repro.{name}"))
    port = _defined(importlib.import_module(f"repro_torch.{name}"))
    omitted = OMITTED.get(name, set())
    assert ref - port == omitted
    assert not omitted & port


@pytest.mark.parametrize("name", sorted(RENAMED))
def test_renamed_module_definitions_match_the_reference(name):
    port_name, renames = RENAMED[name]
    ref = _defined(importlib.import_module(f"repro.{name}"))
    port = _defined(importlib.import_module(f"repro_torch.{port_name}"))
    omitted = OMITTED[name]
    assert ref - port == omitted == set(renames)
    assert {renames.get(n, n) for n in ref} == port


def test_hw_package_exports_the_card_for_the_tpu():
    ref = _public(importlib.import_module("repro.hw"))
    port = _public(importlib.import_module("repro_torch.hw"))
    assert port - ref == {"GpuChipModel", "H100_SXM"}


def test_policies_is_a_live_view_of_the_registry():
    assert core.POLICIES == core.policy_names()
    assert set(core.POLICIES) == set(ref_core.POLICIES)
    name = "throwaway_export_probe"

    @core.register_policy(name)
    def _probe(ctx, cfg):
        raise AssertionError("never compiled")

    try:
        assert name in core.POLICIES
        assert core.POLICIES[-1] == name
    finally:
        del _REGISTRY[name]
    assert name not in core.POLICIES
    with pytest.raises(AttributeError):
        core.NO_SUCH_NAME


def test_available_backends_name_the_ports_devices():
    names = core.available_backends()
    assert names[0] == "cpu" and set(names) <= {"cpu", "cuda"}
    for name in names:
        assert core.get_backend(name).device.type == name


def test_nominal_latency_and_rail_subsets_match_the_reference():
    for net in ("squeezenet1.1", "mobilevit-xxs"):
        got = [nominal_latency(c, ACC)
               for c in characterize_network(edge_network(net), ACC)]
        want = [ref_nominal(c, REF_ACC)
                for c in ref_characterize(ref_network(net), REF_ACC)]
        assert got == want
    levels = voltage_levels()
    for n in (1, 3):
        assert list(rail_subsets(levels, n)) == list(
            ref_rail_subsets(levels, n))


@pytest.mark.parametrize("gating", [True, False])
def test_master_states_match_the_reference(gating):
    net = "squeezenet1.1"
    got = CompilationContext(edge_network(net), network=net) \
        .master_states(gating)
    want = RefContext(ref_network(net), network=net).master_states(gating)
    assert [[(s.voltages, s.t_op, s.e_op, s.label) for s in layer]
            for layer in got] == \
        [[(s.voltages, s.t_op, s.e_op, s.label) for s in layer]
         for layer in want]

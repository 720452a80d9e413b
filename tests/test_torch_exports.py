"""The port's public namespaces against the JAX package's.

For the top level and each subpackage, every public name the JAX package
exports must resolve on the port's counterpart: code written against
``marlin_tpu`` must not fail on ``marlin_tpu_torch`` with an
``AttributeError`` or ``ImportError``. A name that has no counterpart is
listed below with its reason; the list may hold only names the port really
lacks.
"""

import importlib
import importlib.util
import pkgutil
import types

import pytest

SUBPACKAGES = ("", "io", "linalg", "matrix", "ml", "models", "native", "obs",
               "ops", "parallel", "serving", "utils")

# (subpackage, name): why the port has no counterpart
NO_COUNTERPART = {
    ("serving", "aot_compile_buckets"):
        "compiles the buckets for a TPU topology (ROADMAP queue 1 item 13)",
}
# reference modules (under marlin_tpu.) the port has no counterpart of
NO_COUNTERPART_MODULES = {
    "utils.aot": "compiles for a TPU topology (ROADMAP queue 1 item 13)",
    "utils.compat": "the jax version shims (ROADMAP queue 1 item 13)",
}


def _pair(sub):
    suffix = f".{sub}" if sub else ""
    return (importlib.import_module("marlin_tpu" + suffix),
            importlib.import_module("marlin_tpu_torch" + suffix))


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=lambda s: s or "top")
def test_port_exports_every_reference_name(sub):
    """Every public name but the submodules (which attach to a package as
    other code imports them; the next test holds those)."""
    ref, port = _pair(sub)
    missing = sorted(
        n for n in dir(ref) if not n.startswith("_")
        and not isinstance(getattr(ref, n), types.ModuleType)
        and not hasattr(port, n))
    allowed = sorted(n for s, n in NO_COUNTERPART if s == sub)
    assert missing == allowed, (
        f"marlin_tpu_torch{'.' + sub if sub else ''} lacks {missing}; "
        f"listed: {allowed}")


def test_port_has_every_reference_module():
    import marlin_tpu

    missing = []
    for m in pkgutil.walk_packages(marlin_tpu.__path__, "marlin_tpu."):
        if not importlib.util.find_spec(m.name).origin.endswith(".py"):
            continue  # a built library, not a module of the package
        rel = m.name[len("marlin_tpu."):]
        if importlib.util.find_spec("marlin_tpu_torch." + rel) is None:
            missing.append(rel)
    assert sorted(missing) == sorted(NO_COUNTERPART_MODULES)


def test_repaired_names_resolve():
    import marlin_tpu_torch as mt
    from marlin_tpu_torch import models, parallel, serving
    from marlin_tpu_torch.matrix import DistributedMatrix

    assert mt.OutOfCoreMatrix is importlib.import_module(
        "marlin_tpu_torch.matrix").OutOfCoreMatrix
    assert mt.obs.MetricsRegistry is not None
    assert parallel.dim_to_split(1, 5, 2) == 1
    for name in ("ring_matmul", "initialize_distributed"):
        assert callable(getattr(mt, name))
    for name in ("pipeline_apply", "stack_stage_params", "ring_matmul"):
        assert callable(getattr(parallel, name))
    for name in ("plan_context", "ContextPlan", "pp_lm_loss",
                 "pp_lm_train_step", "pp_stage_params", "NeuralNetwork",
                 "pagerank", "ALSModel"):
        assert getattr(models, name) is not None
    assert callable(models.pagerank)  # the function, as in the reference
    assert serving.SlotPool is not None and callable(serving.warmup_buckets)
    assert "save_to_file_system" in DistributedMatrix.__abstractmethods__
    assert "not ported" not in serving.__doc__


def test_planner_ratio_warning_matches_reference():
    """tests/test_programs.py's threshold cases, on both packages."""
    from marlin_tpu.serving import planner_ratio_warning as ref
    from marlin_tpu_torch.serving import planner_ratio_warning as port

    for args in (((8, 4), 100, 100), ((8, 4), 200, 100), ((8, 4), 201, 100),
                 ((8, 4), 100, 0), ((16, 8), 500, 100),
                 ((16, 8), 500, 100, 6.0)):
        assert port(*args) == ref(*args), args
    assert port((16, 8), 500, 100) is not None

"""The port's public surface against the JAX package's: every public name
of ``fealess_tpu`` (top-level functions, classes and their methods,
UPPER_CASE constants, module by module) has a counterpart in the same
module of ``fealess_tpu_torch``, or an entry in ``LEFT_OUT`` whose reason
is one of ``REASONS``.  Both packages are read as source (``ast``), so the
walk imports neither.  A name added to the JAX package later fails here
until it is ported or entered with a reason.

The walk also holds parameter names: every parameter of a JAX function or
method that has a counterpart is accepted by the counterpart under the
same name (JAX callers pass them by keyword), or is entered in
``PARAMS_LEFT_OUT`` with a reason from ``REASONS``."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = os.path.join(REPO, "fealess_tpu")
PORT = os.path.join(REPO, "fealess_tpu_torch")

# JAX modules whose counterpart has another path in the port
MOVED = {"ops/score_pallas.py": "ops/score.py",
         "ops/nn_pallas.py": "ops/nn.py"}

REASONS = ("jit wrapper", "TPU workaround", "tried and left out",
           "Pallas internals", "test/oracle-only", "renamed to",
           "waits for ROADMAP item 10")

# (JAX module, name) -> (reason, detail).  "renamed to" names the port's
# "module:name", which must exist.
LEFT_OUT = {
    ("detector.py", "match_bank_jit"): ("jit wrapper", ""),
    ("pipeline.py", "recognize_top1_jit"): ("jit wrapper", ""),
    ("pipeline.py", "recognize_multi_jit"): ("jit wrapper", ""),
    ("pipeline.py", "refine_match_jit"): ("jit wrapper", ""),
    ("icp.py", "icp_jit"): ("jit wrapper", ""),
    ("tracker/kcf.py", "KcfTracker.update_batch_jit"): ("jit wrapper", ""),
    ("detector.py", "ALLOW_PROFILE_STOPS"): (
        "TPU workaround", "the profile_stop hooks (ROADMAP Open items)"),
    ("ops/luts.py", "similarity_lut_nibbles"): (
        "TPU workaround", "the nibble packing of the Pallas scorers"),
    ("detector.py", "exact_top_k_rows"): (
        "tried and left out", "JAX's per-row top-K, exact but slower on "
        "the card (ROADMAP §2 K1)"),
    ("ops/nn_pallas.py", "TQ"): ("Pallas internals", "ops/nn's tiles"),
    ("ops/nn_pallas.py", "TR"): ("Pallas internals", "ops/nn's tiles"),
    ("ops/nn_pallas.py", "nearest_neighbor_auto"): (
        "Pallas internals", "ops/nn.nearest_neighbor picks the kernel"),
    ("ops/nn_pallas.py", "nearest_neighbor_tiled"): (
        "Pallas internals", "csrc/nn.cu behind ops/nn.nearest_neighbor"),
    ("ops/similarity.py", "LOCAL_WINDOW"): ("test/oracle-only", ""),
    ("ops/similarity.py", "local_similarity"): ("test/oracle-only", ""),
    ("ops/similarity.py", "mask_template_positions"): (
        "test/oracle-only", ""),
    ("ops/similarity.py", "pack_features"): ("test/oracle-only", ""),
    ("ops/similarity.py", "whole_image_similarity"): (
        "test/oracle-only", ""),
    ("ops/response.py", "decimate"): ("test/oracle-only", ""),
    ("ops/response.py", "decimate_2d"): ("test/oracle-only", ""),
    ("ops/response.py", "build_level"): ("test/oracle-only", ""),
    ("ops/response.py", "spread"): (
        "test/oracle-only", "build_level's full-resolution spread; the "
        "port spreads decimated planes (spread_decimated)"),
    ("ops/response.py", "response_maps"): (
        "test/oracle-only", "build_level's response maps"),
    ("geometry/depth.py", "depth_to_3d_sparse"): ("test/oracle-only", ""),
    ("icp.py", "nearest_neighbor"): (
        "renamed to", "ops/nn.py:nearest_neighbor"),
    ("ops/image.py", "distance_transform_chessboard"): (
        "renamed to", "training.py:distance_transform_chessboard"),
    ("utils/profiling.py", "chain_slope"): (
        "renamed to", "utils/profiling.py:device_seconds"),
    ("utils/profiling.py", "time_jitted"): (
        "renamed to", "utils/profiling.py:time_calls"),
    ("apps/cli.py", "cmd_bench"): ("waits for ROADMAP item 10", ""),
}

# (JAX module, function or Class.method, parameter) -> (reason, detail):
# JAX parameter names that the counterpart does not take.
PARAMS_LEFT_OUT = {
    ("detector.py", "match_from_planes", "profile_stop"): (
        "TPU workaround", "the profile_stop hooks (ROADMAP Open items)"),
}


def _modules(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(d, f)
                out[os.path.relpath(path, root).replace(os.sep, "/")] = path
    return out


def _classes(tree):
    return {n.name: n for n in tree.body if isinstance(n, ast.ClassDef)}


def _public(tree, classes_anywhere=None):
    """Public top-level functions, classes, their methods (with the
    methods of bases found in ``classes_anywhere``) and UPPER constants."""
    names = set()

    def methods(cls, seen=()):
        out = {m.name for m in cls.body
               if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}
        for base in cls.bases:
            if (isinstance(base, ast.Name) and classes_anywhere
                    and base.id in classes_anywhere and base.id not in seen):
                out |= methods(classes_anywhere[base.id], seen + (base.id,))
        return out

    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, ast.ClassDef):
            names.add(node.name)
            names |= {f"{node.name}.{m}" for m in methods(node)}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            names |= {t.id for t in targets
                      if isinstance(t, ast.Name) and t.id.isupper()}
    return {n for n in names if not n.split(".")[-1].startswith("_")}


def _functions(tree, classes_anywhere=None):
    """Public top-level functions and class methods (``__init__`` too,
    and the methods of bases found in ``classes_anywhere``) by name:
    their ast nodes."""
    out = {}

    def methods(cls, seen=()):
        found = {}
        for base in cls.bases:
            if (isinstance(base, ast.Name) and classes_anywhere
                    and base.id in classes_anywhere and base.id not in seen):
                found.update(methods(classes_anywhere[base.id],
                                     seen + (base.id,)))
        found.update({m.name: m for m in cls.body if isinstance(
            m, (ast.FunctionDef, ast.AsyncFunctionDef))})
        return found

    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = node
        elif isinstance(node, ast.ClassDef):
            out.update({f"{node.name}.{m}": fn
                        for m, fn in methods(node).items()})
    return {n: fn for n, fn in out.items()
            if not n.split(".")[-1].startswith("_")
            or n.endswith(".__init__")}


def _params(fn):
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
            if x.arg not in ("self", "cls")]


def _parse(path):
    with open(path) as f:
        return ast.parse(f.read(), path)


@pytest.fixture(scope="module")
def surfaces():
    jax_trees = {m: _parse(p) for m, p in _modules(JAX).items()}
    port_trees = {m: _parse(p) for m, p in _modules(PORT).items()}
    anywhere = {}
    for tree in port_trees.values():
        anywhere.update(_classes(tree))
    jax = {m: _public(t) for m, t in jax_trees.items()}
    port = {m: _public(t, anywhere) for m, t in port_trees.items()}
    return jax, port


def test_every_jax_public_name_has_a_port_counterpart(surfaces):
    jax, port = surfaces
    missing = []
    for mod, names in sorted(jax.items()):
        there = port.get(MOVED.get(mod, mod), set())
        missing += [f"{mod}:{n}" for n in sorted(names)
                    if n not in there and (mod, n) not in LEFT_OUT]
    assert not missing, ("public names of fealess_tpu without a port "
                         f"counterpart or a LEFT_OUT entry: {missing}")


def test_left_out_entries_are_current_and_allowed(surfaces):
    jax, port = surfaces
    for (mod, name), (reason, detail) in LEFT_OUT.items():
        assert reason in REASONS, (mod, name, reason)
        assert name in jax.get(mod, set()), (
            f"stale entry: {mod}:{name} is no public name of fealess_tpu")
        assert name not in port.get(MOVED.get(mod, mod), set()), (
            f"stale entry: {mod}:{name} is ported")
        if reason == "renamed to":
            target_mod, target = detail.split(":")
            assert target in port.get(target_mod, set()), detail
    waits = [k for k, (r, _) in LEFT_OUT.items()
             if r == "waits for ROADMAP item 10"]
    assert waits == [("apps/cli.py", "cmd_bench")]


@pytest.fixture(scope="module")
def parameters():
    """(JAX module, function) -> (its parameter names, the counterpart's)
    for every JAX function with a counterpart."""
    jax_trees = {m: _parse(p) for m, p in _modules(JAX).items()}
    port_trees = {m: _parse(p) for m, p in _modules(PORT).items()}
    anywhere = {}
    for tree in port_trees.values():
        anywhere.update(_classes(tree))
    port = {m: _functions(t, anywhere) for m, t in port_trees.items()}
    out = {}
    for mod, tree in jax_trees.items():
        there = port.get(MOVED.get(mod, mod), {})
        for name, fn in _functions(tree).items():
            if name in there:
                out[mod, name] = (_params(fn), _params(there[name]))
    return out


def test_every_jax_parameter_name_is_accepted(parameters):
    missing = [f"{mod}:{name}({p})"
               for (mod, name), (jax_p, port_p) in sorted(parameters.items())
               for p in jax_p
               if p not in port_p and (mod, name, p) not in PARAMS_LEFT_OUT]
    assert not missing, ("JAX parameter names that the port's counterpart "
                         f"does not take and PARAMS_LEFT_OUT omits: "
                         f"{missing}")


def test_params_left_out_entries_are_current_and_allowed(parameters):
    for (mod, name, p), (reason, _) in PARAMS_LEFT_OUT.items():
        assert reason in REASONS, (mod, name, p, reason)
        assert (mod, name) in parameters, f"stale entry: {mod}:{name}"
        jax_p, port_p = parameters[mod, name]
        assert p in jax_p, f"stale entry: {mod}:{name} takes no {p}"
        assert p not in port_p, f"stale entry: {mod}:{name}({p}) is taken"
    workarounds = [k for k, (r, _) in PARAMS_LEFT_OUT.items()
                   if r == "TPU workaround"]
    assert workarounds == [("detector.py", "match_from_planes",
                            "profile_stop")]


def test_inherited_methods_count_as_present(surfaces):
    """``ServingArtifact`` serves through ``ObjReco``'s methods."""
    _, port = surfaces
    assert "ServingArtifact.recognition" in port["io/export.py"]
    assert "ObjReco.compute_pose_epnp" in port["engine.py"]

"""The port's public surface against the JAX package's.

For every module of `stitching_tpu/` (but `ops/pallas/`, whose kernels
the port holds in `ops/kernels/` and `csrc/`), every public name the
module binds at its top level (functions, classes, constants, and dunder
assignments such as `__version__`) must be bound by the port's module of
the same path and be of the same kind (class, function, constant). Every
public member of such a class, inherited ones included, must exist on the
port's class with the same kind, and every parameter of the JAX module's
functions, methods and class constructors must be a parameter of the
port's (by name; `*args` and `**kwargs` by their names too).

A deliberate departure is listed in `DEPARTURES`, keyed by
`"module:name"`, `"module:Class.member"` or `"module:name(param)"`, with
its reason. Each module's departures must be exactly what the walk finds
missing, so an entry cannot go stale: once the port adds the name, the
entry must go. A parameter that the reference's function reads must be
read by the port's too: taking it and ignoring it is no counterpart.

Surface that nothing of the reference uses is not carried into the port:
its entry's reason starts with `UNUSED`, and the test holds that claim
against the reference's code (`stitching_tpu/`, `__graft_entry__.py`,
`bench.py`, `scripts/`) and README. No name, attribute or import there
may name such a function, class member or constant; no call of such a
function may pass such a parameter, by keyword or by position (for
`**kwargs`, no keyword outside the named parameters); a class member is
used where an attribute of its name is read. A call with `*args` or
`**kwargs` counts as a use.
"""

import ast
import importlib
import inspect
import pathlib
import re
import sys
import textwrap

import pytest

import stitching_tpu

UNUSED = "unused in the reference"

DEPARTURES = {
    "ops.orb:detect_orb(with_mask)":
        "a jit static switch: the port gates on `mask is not None`",
    "ops.orb:detect_orb(variant)":
        "a jit static switch: the port picks the detector in "
        "feature_detector.py",
    "ops.orb:detect_orb(exact_topk)":
        "a jit static switch of the reference's top-k; the port's top-k "
        "is exact",
    "ops.sift:detect_sift(with_mask)":
        "a jit static switch: the port gates on `mask is not None`",
    "ops.brisk:detect_brisk(with_mask)":
        "a jit static switch: the port gates on `mask is not None`",
    "ops.akaze:detect_akaze(with_mask)":
        "a jit static switch: the port gates on `mask is not None`",
    "ops.autocalib:focals_from_homography(xp)":
        "the reference's numpy/jax switch; the port has one array library",
    "compose:warp_single(fast)":
        "the port's warp uses no window, so it has no fast-window mode "
        "and none of the reference's `_fast_warp_*` faults (ADVICE.md)",
    "compose:blend_stack(mesh)":
        "the stack carries its own mesh",
    **{f"compose:warp_stack_streamed({p})":
       "the port plans the FINAL pass once and hands the plan over "
       "(`compose.FinalPlan`)" for p in ("sizes", "Ks", "Rs", "scale",
                                          "warper_type")},
    **{f"compose:StreamComposite({p})":
       "built from the blend plan its caller made (`FinalPlan.blend`), "
       "not planned again" for p in ("corners", "sizes", "blender_type",
                                     "blend_strength", "th", "tw")},
    "ops.ransac:ransac_homography(seed)":
        "the port batches pairs and takes their `seeds`",
    "ops.ransac:ransac_affine_partial(seed)":
        "the port batches pairs and takes their `seeds`",
    "parallel.mesh:init_distributed(coordinator_address)":
        "JAX's coordinator; the port uses torch's env:// rendezvous",
    "parallel.mesh:init_distributed(num_processes)":
        "JAX's coordinator; the port uses torch's env:// rendezvous",
    "parallel.mesh:init_distributed(process_id)":
        "JAX's coordinator; the port uses torch's env:// rendezvous",
    "parallel.mesh:init_distributed(local_device_ids)":
        "JAX's coordinator; the port uses torch's env:// rendezvous",
    "parallel.mesh:make_mesh(axis_name)":
        "the port's mesh has one axis, unnamed",
    "parallel.mesh:shard_leading(axis_name)":
        "the port's mesh has one axis, unnamed",
    "profiling:fence(*arrays)":
        "named `*tensors` in the port",
    "cli.stitch:__doc__":
        "the reference appends to its docstring at import; the port's "
        "docstring is written whole",
    "ops.resize:resize_device":
        UNUSED + ": the port's device resizes are `pipeline.resize_stack` "
        "and `seam_finder`'s",
    "ops.exposure:smooth_gain_map(iters)":
        UNUSED + ": every caller smooths twice",
    "ops.orb:fast_corners(threshold)":
        UNUSED + ": every caller takes `FAST_THRESHOLD`",
    "ops.ransac:ransac_affine_partial(n_iters)":
        UNUSED + ": every caller draws `N_HYPOTHESES`",
    "compose:TileStack.tile":
        UNUSED + ": tiles leave the card through `to_host()`",
    "compose:TileStack.mask":
        UNUSED + ": masks leave the card through `to_host()`",
    "feature_matcher:FeatureMatcher.match_features(**kwargs)":
        UNUSED + ": no caller passes another keyword, and accepting any "
        "would swallow a misspelt `mesh=`",
    "feature_matcher:FeatureMatcher.match_stacked_dispatch(mesh)":
        UNUSED + ": the engine calls it without a mesh",
}

# Deliberate departures in what a function computes, where its surface is
# the JAX function's: keyed as above, each with its reason and the test
# that holds the port's behaviour where the JAX package's differs.
BEHAVIOUR = {
    "ops.ransac:ransac_homography": (
        "drops minimal samples that fold, as cv::findHomography checks its "
        "samples: on an overlap that is a thin strip the JAX package's vote "
        "can go to a folded hypothesis that takes in matches far off the "
        "truth, and one such pair over the confidence threshold bends the "
        "bundle adjustment of a grid capture",
        "tests/test_torch_ransac.py::test_folded_sample_loses_the_vote"),
}

JAX_ROOT = pathlib.Path(inspect.getsourcefile(stitching_tpu)).parent
MODULES = sorted(
    ".".join(p.relative_to(JAX_ROOT).with_suffix("").parts).removesuffix(
        "__init__").rstrip(".")
    for p in JAX_ROOT.rglob("*.py")
    if p.relative_to(JAX_ROOT).parts[:2] != ("ops", "pallas"))


def _import(package, module):
    return importlib.import_module(package + ("." + module if module else ""))


def _source(mod):
    return pathlib.Path(inspect.getsourcefile(mod)).read_text()


def _top_level(tree):
    """The module's top-level statements, through `if` and `try` blocks."""
    todo = list(tree.body)
    while todo:
        node = todo.pop(0)
        if isinstance(node, (ast.If, ast.Try)):
            todo[:0] = (node.body + node.orelse
                        + getattr(node, "finalbody", [])
                        + [s for h in getattr(node, "handlers", [])
                           for s in h.body])
        else:
            yield node


def _bound(mod, imports):
    """Names the module binds at its top level: defined, assigned and, with
    `imports`, imported; without, a package's `__init__` still counts its
    re-exports of its own modules."""
    init = mod.__name__ == mod.__package__
    names = []
    for node in _top_level(ast.parse(_source(mod))):
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        names.append(n.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)) and (
                imports or init and getattr(node, "level", 0) > 0):
            names += [(a.asname or a.name).split(".")[0] for a in node.names]
    return list(dict.fromkeys(names))


def _public(name):
    return not name.startswith("_") or (name.startswith("__")
                                        and name.endswith("__"))


def _kind(obj):
    if inspect.isclass(obj):
        return "class"
    return "function" if callable(obj) else "constant"


def _params(obj):
    try:
        sig = inspect.signature(obj)
    except (TypeError, ValueError):
        return []
    prefix = {inspect.Parameter.VAR_POSITIONAL: "*",
              inspect.Parameter.VAR_KEYWORD: "**"}
    return [prefix.get(p.kind, "") + p.name for p in sig.parameters.values()]


def _missing_params(key, ref, port):
    have = set(_params(port))
    return [f"{key}({p})" for p in _params(ref) if p not in have]


def _members(cls):
    return [m for m in dir(cls) if not m.startswith("_")
            and not hasattr(object, m)]


def _class_gaps(key, ref, port):
    """What the port's class lacks of the reference's: members (inherited
    ones too), their kinds and parameters, nested classes recursively."""
    gaps = _missing_params(key, ref, port)
    for m in _members(ref):
        a = getattr(ref, m)
        if not hasattr(port, m):
            gaps.append(f"{key}.{m}")
            continue
        b = getattr(port, m)
        if _kind(a) != _kind(b):
            gaps.append(f"{key}.{m} is a {_kind(b)}, not a {_kind(a)}")
        elif inspect.isclass(a) and a.__qualname__.startswith(
                ref.__qualname__ + "."):
            gaps += _class_gaps(f"{key}.{m}", a, b)
        elif _kind(a) == "function":
            gaps += _missing_params(f"{key}.{m}", a, b)
    return gaps


def surface_gaps(module):
    """Every public name, member and parameter of the JAX module that the
    port's module lacks, as DEPARTURES keys."""
    ref_mod = _import("stitching_tpu", module)
    port_mod = _import("stitching_tpu_torch", module)
    port_names = set(_bound(port_mod, imports=True))
    gaps = []
    for name in filter(_public, _bound(ref_mod, imports=False)):
        key = f"{module}:{name}"
        if name not in port_names:
            gaps.append(key)
            continue
        ref, port = getattr(ref_mod, name), getattr(port_mod, name)
        if _kind(ref) != _kind(port):
            gaps.append(f"{key} is a {_kind(port)}, not a {_kind(ref)}")
        elif inspect.isclass(ref):
            gaps += _class_gaps(key, ref, port)
        elif _kind(ref) == "function":
            gaps += _missing_params(key, ref, port)
    return gaps


def _reads(fn, name):
    """Whether the function's own source reads `name` (None when there is
    no Python source to read)."""
    fn = inspect.unwrap(fn)
    try:
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    except (TypeError, OSError):      # a builtin or a generated __init__
        return None
    return any(isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
               and n.id == name for n in ast.walk(tree.body[0]))


def _ignored(key, ref, port):
    if inspect.isclass(ref):
        ref, port = ref.__init__, port.__init__
    return [f"{key}({p})" for p in _params(ref)
            if p.lstrip("*") not in ("self", "cls") and p in _params(port)
            and _reads(ref, p.lstrip("*"))
            and _reads(port, p.lstrip("*")) is False]


def ignored_params(module):
    """Parameters that the JAX module's functions, methods and constructors
    read and the port's counterparts take but never read."""
    ref_mod = _import("stitching_tpu", module)
    port_mod = _import("stitching_tpu_torch", module)
    port_names = set(_bound(port_mod, imports=True))
    found = []
    for name in filter(_public, _bound(ref_mod, imports=False)):
        if name not in port_names:
            continue
        key = f"{module}:{name}"
        ref, port = getattr(ref_mod, name), getattr(port_mod, name)
        if _kind(ref) != _kind(port) or _kind(ref) == "constant":
            continue
        found += _ignored(key, ref, port)
        if inspect.isclass(ref):
            for m in _members(ref):
                a, b = getattr(ref, m), getattr(port, m, None)
                if _kind(a) == "function" and b is not None:
                    found += _ignored(f"{key}.{m}", a, b)
    return found


REPO = JAX_ROOT.parent


def _reference_sources():
    """(path, text) of every Python file of the reference and its tools."""
    paths = sorted(JAX_ROOT.rglob("*.py")) + [
        REPO / "__graft_entry__.py", REPO / "bench.py"] + sorted(
        (REPO / "scripts").glob("*.py"))
    return [(str(p.relative_to(REPO)), p.read_text()) for p in paths
            if p.exists()]


def _callee(node):
    f = node.func
    return f.id if isinstance(f, ast.Name) else getattr(f, "attr", None)


def _passes(call, param, ref):
    """Whether the call may pass `param` of the reference's `ref`."""
    if (any(isinstance(a, ast.Starred) for a in call.args)
            or any(k.arg is None for k in call.keywords)):
        return True
    sig = inspect.signature(ref)
    named = [p.name for p in sig.parameters.values()
             if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    if named and named[0] == "self":
        named = named[1:]
    if param.startswith("**"):
        return any(k.arg not in sig.parameters for k in call.keywords)
    if any(k.arg == param for k in call.keywords):
        return True
    return param in named and len(call.args) > named.index(param)


def reference_uses(key, sources=None, readme=None):
    """Where the reference's code or README uses what `key` names."""
    module, rest = key.split(":")
    path, _, param = rest.partition("(")
    param = param.rstrip(")")
    target = path.split(".")[-1]
    ref = _import("stitching_tpu", module)
    for part in path.split("."):
        ref = getattr(ref, part)
    if sources is None:
        sources = _reference_sources()
    if readme is None:
        readme = (REPO / "README.md").read_text()
    uses = []
    for name, text in sources:
        for node in ast.walk(ast.parse(text)):
            if param:
                hit = (isinstance(node, ast.Call) and _callee(node) == target
                       and _passes(node, param, ref))
            elif "." in path:          # a class member: read as an attribute
                hit = isinstance(node, ast.Attribute) and node.attr == target
            else:
                hit = (isinstance(node, ast.Name)
                       and isinstance(node.ctx, ast.Load)
                       and node.id == target
                       or isinstance(node, ast.Attribute)
                       and node.attr == target
                       or isinstance(node, ast.alias)
                       and target in (node.name, node.asname))
            if hit:
                uses.append(f"{name}:{getattr(node, 'lineno', '?')}")
    word = (rf"\b{param.lstrip('*')}\b" if param
            else rf"\.{target}\b" if "." in path else rf"\b{target}\b")
    for n, line in enumerate(readme.splitlines(), 1):
        if re.search(word, line) and (not param or f"{target}(" in line):
            uses.append(f"README.md:{n}")
    return uses


@pytest.mark.parametrize("module", MODULES, ids=lambda m: m or "__init__")
def test_port_module_has_the_jax_surface(module):
    listed = {k for k in DEPARTURES if k.split(":")[0] == module}
    gaps = surface_gaps(module)
    assert sorted(set(gaps) - listed) == [], "missing from the port"
    assert sorted(listed - set(gaps)) == [], (
        "listed as departures but present in the port: drop them from "
        "DEPARTURES")


@pytest.mark.parametrize("module", MODULES, ids=lambda m: m or "__init__")
def test_port_reads_what_the_jax_module_reads(module):
    """A parameter that the port takes but ignores is no counterpart of
    one that the reference acts on."""
    assert ignored_params(module) == []


def test_ignored_parameter_is_found(monkeypatch):
    from stitching_tpu_torch.ops import exposure

    def smooth_gain_map(gain, present):
        return gain.copy()

    monkeypatch.setattr(exposure, "smooth_gain_map", smooth_gain_map)
    assert ignored_params("ops.exposure") == [
        "ops.exposure:smooth_gain_map(present)"]


def test_departures_name_walked_modules():
    assert len(MODULES) >= 40 and "ops.pallas.two_nn" not in MODULES
    for key, reason in DEPARTURES.items():
        assert key.split(":")[0] in MODULES, key
        assert reason.strip(), key


def test_walk_finds_a_dropped_name(monkeypatch):
    """The walk sees a parameter, a member and a name that the port lacks."""
    from stitching_tpu_torch import compose
    from stitching_tpu_torch.ops import pyramid, resize

    monkeypatch.setattr(compose.TileStack, "to_host", property(lambda s: 0))
    monkeypatch.setattr(resize, "resize", lambda img: img)
    assert "compose:TileStack.to_host is a constant, not a function" in (
        surface_gaps("compose"))
    assert "ops.resize:resize(size_wh)" in surface_gaps("ops.resize")
    read = _source
    monkeypatch.setattr(sys.modules[__name__], "_source", lambda m: read(
        m).replace("KERNEL5 =", "_KERNEL5 =") if m is pyramid else read(m))
    assert "ops.pyramid:KERNEL5" in surface_gaps("ops.pyramid")


@pytest.mark.parametrize("key", sorted(
    k for k, why in DEPARTURES.items() if why.startswith(UNUSED)))
def test_unused_departure_has_no_use_in_the_reference(key):
    assert reference_uses(key) == []


@pytest.mark.parametrize("key,text,readme", [
    ("ops.exposure:smooth_gain_map(iters)",
     "smooth_gain_map(g, p, iters=3)", ""),
    ("ops.exposure:smooth_gain_map(iters)", "ex.smooth_gain_map(g, p, 3)",
     ""),
    ("ops.exposure:smooth_gain_map(iters)", "smooth_gain_map(*a)", ""),
    ("ops.exposure:smooth_gain_map(iters)", "",
     "`smooth_gain_map(gain, present, iters=1)`"),
    ("ops.orb:fast_corners(threshold)", "fast_corners(g, **kw)", ""),
    ("feature_matcher:FeatureMatcher.match_features(**kwargs)",
     "m.match_features(f, meshh=mesh)", ""),
    ("feature_matcher:FeatureMatcher.match_stacked_dispatch(mesh)",
     "m.match_stacked_dispatch(f, s, b, n_images=2, mesh=mesh)", ""),
    ("compose:TileStack.tile", "stack.tile(0)", ""),
    ("compose:TileStack.tile", "", "`TileStack.tile(i)` copies a tile"),
    ("ops.resize:resize_device", "from .ops.resize import resize_device",
     ""),
    ("ops.resize:resize_device", "", "call `resize_device` on the card"),
])
def test_use_scan_finds_a_use(key, text, readme):
    """The scan behind `UNUSED` finds a use in code or README, and none in
    a call that leaves the parameter at its default."""
    assert reference_uses(key, [("x.py", text)], readme) != []


@pytest.mark.parametrize("key,text", [
    ("ops.exposure:smooth_gain_map(iters)", "smooth_gain_map(g, p)"),
    ("ops.orb:fast_corners(threshold)", "fast_corners(gray)"),
    ("feature_matcher:FeatureMatcher.match_features(**kwargs)",
     "m.match_features(f, mesh=mesh)"),
    ("compose:TileStack.tile", "tile = warp(x)\nstack.tiles"),
])
def test_use_scan_passes_a_default_call(key, text):
    assert reference_uses(key, [("x.py", text)],
                          "each warped tile and its mask") == []


@pytest.mark.parametrize("key", sorted(BEHAVIOUR))
def test_behaviour_departure_is_held_by_its_test(key):
    """Each behaviour departure names a function of both packages and a
    test of the port that exists."""
    module, name = key.split(":")
    assert module in MODULES
    assert callable(getattr(_import("stitching_tpu", module), name))
    assert callable(getattr(_import("stitching_tpu_torch", module), name))
    reason, held_by = BEHAVIOUR[key]
    path, test = held_by.split("::")
    assert reason and f"def {test}(" in (REPO / path).read_text()

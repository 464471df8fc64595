"""Generate docs/api_reference.md from the package's docstrings.

The reference ships Sphinx autodoc (`docs/source/index.rst` +
readthedocs); this image has no sphinx, so this is a dependency-free
autodoc: it introspects the public surface (module docstring, public
classes with their public methods, public functions — full signatures +
docstrings) and emits one markdown file, kept checked in so the API
reference is always buildable and always current.

Run:  python docs/gen_api_docs.py        (rewrites docs/api_reference.md)
Test: tests/test_docs.py regenerates and diffs against the checked-in
      copy, so a drifting signature fails CI.
"""
import importlib
import inspect
import io
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
jax.config.update("jax_platforms", "cpu")

MODULES = [
    "stochqn_tpu",
    "stochqn_tpu.free",
    "stochqn_tpu.guided",
    "stochqn_tpu.fused",
    "stochqn_tpu.api",
    "stochqn_tpu.optax_adapter",
    "stochqn_tpu.native_backend",
    "stochqn_tpu.core.config",
    "stochqn_tpu.core.state",
    "stochqn_tpu.core.olbfgs",
    "stochqn_tpu.core.sqn",
    "stochqn_tpu.core.adaqn",
    "stochqn_tpu.ops.two_loop",
    "stochqn_tpu.ops.pairs",
    "stochqn_tpu.ops.accumulators",
    "stochqn_tpu.models.logistic",
    "stochqn_tpu.models.losses",
    "stochqn_tpu.models.mlp",
    "stochqn_tpu.models.sparse",
    "stochqn_tpu.parallel.mesh",
    "stochqn_tpu.parallel.distributed",
    "stochqn_tpu.parallel.evaluate",
    "stochqn_tpu.utils.schedules",
    "stochqn_tpu.utils.checkpoint",
    "stochqn_tpu.utils.metrics",
    "stochqn_tpu.utils.data",
]


def _sig(obj):
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj, indent=""):
    d = inspect.getdoc(obj)
    if not d:
        return ""
    return "\n".join(indent + line if line else ""
                     for line in d.split("\n")) + "\n"


def _is_public(name, obj, mod):
    if name.startswith("_"):
        return False
    return getattr(obj, "__module__", None) == mod.__name__


def render_module(out, name):
    mod = importlib.import_module(name)
    out.write(f"\n## `{name}`\n\n")
    out.write(_doc(mod) + "\n")

    members = [(n, o) for n, o in inspect.getmembers(mod)
               if _is_public(n, o, mod)]
    for n, o in members:
        if inspect.isclass(o):
            bases = ", ".join(b.__name__ for b in o.__bases__
                              if b is not object)
            head = f"### class `{n}{'(' + bases + ')' if bases else ''}`"
            out.write(head + "\n\n")
            out.write(_doc(o))
            init = o.__dict__.get("__init__")
            if init is not None and callable(init):
                out.write(f"\n```python\n{n}{_sig(init)}\n```\n")
            for mn, mo in inspect.getmembers(o):
                if mn.startswith("_") or not callable(mo):
                    continue
                if mn not in vars(o):    # skip inherited, shown on base
                    continue
                out.write(f"\n**`.{mn}{_sig(mo)}`**\n\n")
                out.write(_doc(mo, ""))
            out.write("\n")
    for n, o in members:
        # jit-wrapped functions (e.g. the Pallas kernel entry points) are
        # PjitFunction objects, not plain functions — unwrap for the check
        # and the signature/docstring
        target = inspect.unwrap(getattr(o, "__wrapped__", o))
        if inspect.isfunction(target):
            out.write(f"### `{n}{_sig(target)}`\n\n")
            out.write(_doc(target) + "\n")


def generate() -> str:
    out = io.StringIO()
    out.write(
        "# stochqn_tpu — API reference\n\n"
        "Auto-generated from docstrings by `docs/gen_api_docs.py`; do not\n"
        "edit by hand (regenerate with `python docs/gen_api_docs.py`).\n"
        "Narrative docs: [design](design.md), [protocol](protocol.md),\n"
        "[api guide](api.md), [migration](migration.md),\n"
        "[R bindings](r_bindings.md).\n")
    for name in MODULES:
        render_module(out, name)
    return out.getvalue()


if __name__ == "__main__":
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "api_reference.md")
    text = generate()
    with open(path, "w") as f:
        f.write(text)
    print(f"wrote {path} ({len(text.splitlines())} lines)")

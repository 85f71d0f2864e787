"""The plain reference of the benchmark's models: fp32 PyTorch with TF32
off, no kernel, no cache and no batching of the program. It imports
nothing of the program and takes nothing the program made: its weights
come from the seed through ``bench.weights``, one layer at a time.

A configuration's file names the module of its model by its top-level key
``"reference"``: ``reference/<name>.py`` under the benchmark's folder,
loaded by path; without the key it is ``reference/model.py``. A model
module defines what is particular to the model:

* ``block_leaves(m, moe_layer)``: one layer's leaves in the program's
  tree, each (path within the layer, shape, a norm scale of ones?, read
  in fp32 when served in bf16?);
* ``layer_matmul_params(m, moe_layer)``: the matrix parameters one token
  multiplies in one layer (``bench/work.py`` composes a step's FLOPs);
* ``serve_logits(m, layer_weights, top_weights, units, prec, device)``:
  the fp32 logits at the positions that served a token;
* ``loss(m, params, tokens, labels, prec)``: the training loss.

The rest (``Prec``, the building blocks, the routing groups) is in
``reference/common.py`` for any module to import.

A reference is independent of what it judges: a model module imports
nothing of the program (``repro_torch``), of JAX or of the JAX package,
and of the benchmark's own code only ``bench.reference`` and
``bench.weights``, which import none of those either. ``load`` refuses a
module that imports anything else of them; a test holds every file here
to the same rule.
"""

from __future__ import annotations

import ast
import importlib.util
import pathlib
import re
import sys

NEEDS = ("block_leaves", "layer_matmul_params", "serve_logits", "loss")
PROGRAM = ("jax", "jaxlib", "flax", "repro", "repro_torch")
OWN = ("bench.reference", "bench.weights")
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def foreign_imports(source: str) -> list:
    """The modules ``source`` imports that a reference may not: the
    program, JAX or the JAX package, or the benchmark's code outside
    ``OWN``."""
    bad = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [f"bench.{a.name}" if node.module == "bench"
                     else node.module for a in node.names]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            if top in PROGRAM or (top == "bench" and not any(
                    n == o or n.startswith(o + ".") for o in OWN)):
                bad.append(n)
    return bad


def load(root, name=None):
    """The model module ``name`` under ``root`` (the benchmark's folder),
    or ``reference/model.py`` where the configuration names none."""
    if name is None:
        from bench.reference import model
        return model
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"reference {name!r} is not a module name")
    path = pathlib.Path(root) / "reference" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"the configuration's reference {name!r}: "
                                f"no {path}")
    bad = foreign_imports(path.read_text())
    if bad:
        raise ValueError(f"{path} imports {bad}: a reference imports nothing "
                         f"of the program or of JAX")
    key = f"bench_reference_{name}"
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    missing = [n for n in NEEDS if not callable(getattr(mod, n, None))]
    if missing:
        raise ValueError(f"{path} defines no {missing}")
    return mod

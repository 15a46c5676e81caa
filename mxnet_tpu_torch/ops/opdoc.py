"""Signature and docstring of the generated ``mx.nd`` op functions (ref:
the JAX package's ``ops/opdoc.py``; python/mxnet/ndarray/register.py,
which builds both from each op's C++ parameter struct).

A registry op is a Python function, so its own signature carries that
metadata: array inputs are the leading positional parameters, op
parameters the keyword parameters with defaults. :func:`signature_and_doc`
turns it into an ``inspect.Signature`` (``help(nd.Convolution)`` lists
the typed parameters, IDEs complete them) and a numpydoc docstring.
"""
from __future__ import annotations

import inspect
from typing import Any, Tuple

__all__ = ["signature_and_doc"]

#: filled in by the front end, never by the caller
_HIDDEN = {"_key", "_training", "generator"}


def _type_name(default: Any) -> str:
    if isinstance(default, bool):
        return "boolean"
    if isinstance(default, int):
        return "int"
    if isinstance(default, float):
        return "float"
    if isinstance(default, str):
        return "string"
    if isinstance(default, (tuple, list)):
        return "Shape(tuple)"
    return "any"


def _split_params(opdef) -> Tuple[list, list, bool]:
    """(array inputs, [(param, default)], variadic) of the op function."""
    try:
        sig = inspect.signature(opdef.fn)
    except (TypeError, ValueError):
        return [], [], True
    inputs, params = [], []
    variadic = False
    # a random creation op takes ctx= beside its generator, where the JAX
    # front end injects a key: the front end documents ctx once
    hidden = _HIDDEN | ({"ctx"} if opdef.rng and opdef.creation else set())
    for p in sig.parameters.values():
        if p.name in hidden:
            continue
        if p.kind == p.VAR_POSITIONAL:
            variadic = True
        elif p.kind == p.VAR_KEYWORD:
            continue
        elif p.default is p.empty:
            inputs.append(p.name)
        else:
            params.append((p.name, p.default))
    return inputs, params, variadic


def signature_and_doc(name: str, opdef, creation: bool = False,
                      symbol: bool = False):
    """``(inspect.Signature, docstring)`` of the front-end function."""
    inputs, params, variadic = _split_params(opdef)
    kind_arr = "Symbol" if symbol else "NDArray"
    P = inspect.Parameter
    sig_params = [P(n, P.POSITIONAL_OR_KEYWORD) for n in inputs]
    if variadic:
        var_name = "args" if "args" not in inputs else "more_args"
        sig_params.append(P(var_name, P.VAR_POSITIONAL))
    for n, d in params:
        sig_params.append(P(n, P.KEYWORD_ONLY, default=d))
    used = {p.name for p in sig_params}
    if creation and "ctx" not in used:
        sig_params.append(P("ctx", P.KEYWORD_ONLY, default=None))
    if not symbol and "out" not in used:
        sig_params.append(P("out", P.KEYWORD_ONLY, default=None))
    if "name" not in used:
        sig_params.append(P("name", P.KEYWORD_ONLY, default=None))
    signature = inspect.Signature(sig_params)

    lines = []
    body = (opdef.doc or "").strip()
    if body:
        lines += [body, ""]
    lines += ["Parameters", "----------"]
    for n in inputs:
        lines += [f"{n} : {kind_arr}", f"    Input {kind_arr.lower()}."]
    if variadic:
        lines += [f"*args : {kind_arr}(s)", "    Variadic input arrays."]
    for n, d in params:
        lines.append(f"{n} : {_type_name(d)}, optional, default={d!r}")
    if creation:
        lines += ["ctx : Context, optional",
                  "    Device context of the output."]
    if not symbol:
        lines += ["out : NDArray, optional",
                  "    Output buffer (written in place)."]
    lines += ["name : string, optional", "    Name hint (symbolic graphs).",
              "", "Returns", "-------"]
    n_out = opdef.num_outputs
    if callable(n_out) or (isinstance(n_out, int) and n_out > 1):
        lines.append(f"tuple of {kind_arr}")
    else:
        lines.append(f"out : {kind_arr}")
    return signature, "\n".join(lines)

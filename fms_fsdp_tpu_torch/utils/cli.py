"""Minimal fire-style CLI: ``main_training_llama.py --key=value ...``.

The reference exposes arbitrary config kwargs through ``fire.Fire(main)``
(ref:main_training_llama.py:174-175, scripts/train.sh:24-31). This parser
accepts the same surface — ``--key=value``, ``--key value``, dotted
``ClassName.param=value`` — with literal-eval typing, no dependency.
"""

import ast
from typing import Dict, List, Optional


def _coerce(value: str):
    low = value.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("none", "null"):
        return None
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def parse_cli_args(argv: List[str]) -> Dict[str, object]:
    """argv (sans program name) -> kwargs dict."""
    kwargs = {}
    key: Optional[str] = None
    for token in argv:
        if token.startswith("--"):
            if key is not None:
                kwargs[key] = True  # bare flag
            body = token[2:]
            if "=" in body:
                k, v = body.split("=", 1)
                kwargs[k] = _coerce(v)
                key = None
            else:
                key = body
        elif key is not None:
            kwargs[key] = _coerce(token)
            key = None
        elif "=" in token:
            k, v = token.split("=", 1)
            kwargs[k] = _coerce(v)
        else:
            raise ValueError(f"Cannot parse CLI token: {token}")
    if key is not None:
        kwargs[key] = True
    return kwargs

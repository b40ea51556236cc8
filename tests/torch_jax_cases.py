"""Replay the orchestration cases of a JAX test module against the port.

The fleet router, its journal, the replica supervisor and the chunked
transport are plain Python in both packages, with the same names at the
same relative paths. A slice of a JAX test module (the cases that use
only those classes, on fake replicas and a fake clock) is read, every
``fms_fsdp_tpu.`` module path in it is renamed to ``fms_fsdp_tpu_torch.``,
and the result is executed in a fresh namespace: its test functions then
run JAX's cases, unchanged, on the port's classes. The JAX test modules
themselves are untouched and still run on the JAX package.
"""

import os

TESTS = os.path.dirname(os.path.abspath(__file__))


def port_cases(filename: str, start: str = "", end: str = "", prelude: str = "",
               port: bool = True) -> dict:
    """The namespace of ``tests/<filename>`` from the first line that
    starts with ``start`` (the top when empty) to the line before the
    first that starts with ``end`` (the bottom when empty), run after
    ``prelude`` against the port (against the JAX package itself when
    ``port`` is False, for side-by-side runs)."""
    with open(os.path.join(TESTS, filename)) as f:
        lines = f.read().splitlines()
    i = next(n for n, line in enumerate(lines) if line.startswith(start)) if start else 0
    j = next(n for n in range(i + 1, len(lines)) if lines[n].startswith(end)) if end else len(lines)
    src = prelude + "\n" + "\n".join(lines[i:j]) + "\n"
    if port:
        src = src.replace("fms_fsdp_tpu.", "fms_fsdp_tpu_torch.")
    ns = {"__name__": f"{'port' if port else 'jax'}_cases_{filename[:-3]}"}
    exec(compile(src, f"{filename} (against fms_fsdp_tpu_torch)", "exec"), ns)
    return ns


def export_tests(ns: dict, into: dict, fixtures=()) -> list:
    """Copy ``ns``'s test functions (and the named fixtures) into a test
    module's globals; returns the test names."""
    names = [k for k in ns if k.startswith("test_") and callable(ns[k])]
    for k in names:
        into[k] = ns[k]
    for k in fixtures:
        into[k] = ns[k]
    return names

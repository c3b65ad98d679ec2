"""Runs a test module of the JAX package against the port.

``exec_against_port("test_pipeline", globals())`` executes
``tests/test_pipeline.py`` with every import of ``pilosa_tpu`` pointed at
``pilosa_tpu_torch``, into the namespace of the test file that asks, so
pytest collects each of its cases there, once, on the port. The
reference's own file keeps running them on ``pilosa_tpu``. Lines keep
their numbers, so a failure points into the reference's file."""

from __future__ import annotations

import dataclasses
import pathlib
import re
import types

# an import statement of the JAX package, at any indent
_IMPORT = re.compile(r"^(\s*(?:from|import)\s+)pilosa_tpu\b(?!_torch)", re.M)


def _of_reference(v) -> bool:
    name = v.__name__ if isinstance(v, types.ModuleType) else getattr(v, "__module__", None)
    return isinstance(name, str) and (name == "pilosa_tpu" or name.startswith("pilosa_tpu."))


def exec_against_port(module: str, namespace: dict) -> None:
    path = pathlib.Path(__file__).with_name(f"{module}.py")
    src = _IMPORT.sub(r"\1pilosa_tpu_torch", path.read_text())
    exec(compile(src, str(path), "exec"), namespace)
    left = sorted(k for k, v in namespace.items() if _of_reference(v))
    if left:
        raise ImportError(f"{module}: names still bound to pilosa_tpu: {left}")


def cpu_config(cls):
    """The port's ``Config`` with ``device="cpu"`` by default: the
    reference's servers run the kernels' plain versions."""

    @dataclasses.dataclass
    class CpuConfig(cls):
        device: str = "cpu"

    return CpuConfig

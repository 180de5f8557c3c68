"""ModuleSpec: a JSON-serializable spec for a callable + partial kwargs.

The port's copy of hypervla_tpu/utils/spec.py.

Parity: octo/utils/spec.py:6-96. This is what makes checkpoint config.json
files self-contained: any tokenizer/head/transform is stored as
{module, name, args, kwargs} and re-imported at load time.
"""
import importlib
from functools import partial
from typing import Any, Dict, Tuple, TypedDict


class ModuleSpec(TypedDict):
    """A dict specifying a callable: imported from `module`:`name`, bound with
    `args`/`kwargs` via functools.partial."""

    module: str
    name: str
    args: Tuple[Any, ...]
    kwargs: Dict[str, Any]

    @staticmethod
    def create(callable_or_full_name, *args, **kwargs) -> "ModuleSpec":  # type: ignore
        if isinstance(callable_or_full_name, str):
            assert callable_or_full_name.count(":") == 1, (
                "full name must be in the form 'module:name'"
            )
            module, name = callable_or_full_name.split(":")
        else:
            module, name = _infer_full_name(callable_or_full_name)
        return ModuleSpec(module=module, name=name, args=args, kwargs=kwargs)

    @staticmethod
    def instantiate(spec: "ModuleSpec"):  # type: ignore
        if isinstance(spec, str):
            spec_dict = ModuleSpec.from_string(spec)
            return ModuleSpec.instantiate(spec_dict)
        assert set(spec.keys()) == {"module", "name", "args", "kwargs"}, (
            f"expected ModuleSpec, got {spec}"
        )
        cls = _import_from_string(spec["module"], spec["name"])
        return partial(cls, *spec["args"], **spec["kwargs"])

    @staticmethod
    def to_string(spec: "ModuleSpec") -> str:  # type: ignore
        args = ", ".join(
            [f"{a!r}" for a in spec["args"]]
            + [f"{k}={v!r}" for k, v in spec["kwargs"].items()]
        )
        return f"{spec['module']}:{spec['name']}({args})"

    @staticmethod
    def from_string(s: str) -> "ModuleSpec":  # type: ignore
        """Inverse of to_string for specs without args/kwargs."""
        head = s.split("(")[0]
        module, name = head.split(":")
        return ModuleSpec(module=module, name=name, args=(), kwargs={})


def _infer_full_name(o: object):
    if hasattr(o, "__module__") and hasattr(o, "__name__"):
        return o.__module__, o.__name__
    raise ValueError(
        f"Cannot infer identifier for {o}: pass a 'module:name' string instead."
    )


def _import_from_string(module_string: str, name: str):
    try:
        module = importlib.import_module(module_string)
        return getattr(module, name)
    except Exception as e:
        raise ValueError(f"Could not import {module_string}:{name}") from e

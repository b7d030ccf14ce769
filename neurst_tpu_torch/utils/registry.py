"""Named registries (the port's own trimmed copy of the
``setup_registry`` idea in ``neurst_tpu/utils/registry.py``).

``setup_registry(name)`` returns ``(build, register)``.  A registered
class is found by its class name, its snake_case form or any alias.
``build`` takes a name string, or a dict with ``{name}.class`` and
``{name}.params`` (or ``class`` / ``params``), fills the defaults the
class declares in ``default_params()``, and calls ``create_fn``.
"""

import re
from typing import Callable, Dict, Optional

__all__ = ["setup_registry", "camel_to_snake"]


def camel_to_snake(name: str) -> str:
    s1 = re.sub(r"(.)([A-Z][a-z]+)", r"\1_\2", name)
    return re.sub(r"([a-z0-9])([A-Z])", r"\1_\2", s1).lower()


def setup_registry(registry_name: str, base_class=None,
                   create_fn: Optional[Callable] = None):
    registry: Dict[str, type] = {}

    def do_register(cls, names):
        if base_class is not None and not issubclass(cls, base_class):
            raise TypeError(f"{cls.__name__} must extend "
                            f"{base_class.__name__} to be registered in "
                            f"'{registry_name}'")
        for n in [*names, cls.__name__, camel_to_snake(cls.__name__)]:
            key = n if n == cls.__name__ else n.lower()
            if registry.get(key, cls) is not cls:
                raise LookupError(f"name '{n}' already registered in "
                                  f"'{registry_name}'")
            registry[key] = cls
        return cls

    def register(*args):
        if len(args) == 1 and isinstance(args[0], type):
            return do_register(args[0], [])
        return lambda cls: do_register(cls, list(args))

    def build(args, **kwargs):
        if isinstance(args, str):
            cls_name, params = args, {}
        elif isinstance(args, dict):
            key = f"{registry_name}.class"
            if key in args:
                cls_name = args[key]
                params = args.get(f"{registry_name}.params") or {}
            elif "class" in args:
                cls_name, params = args["class"], args.get("params") or {}
            else:
                raise ValueError(f"build_{registry_name} needs '{key}' or "
                                 f"'class', got keys {sorted(args)}")
        else:
            raise ValueError(f"build_{registry_name}: unsupported args "
                             f"{type(args)}")
        cls = registry.get(cls_name) or registry.get(str(cls_name).lower())
        if cls is None:
            raise LookupError(f"'{cls_name}' is not registered in "
                              f"'{registry_name}'. Known: {sorted(registry)}")
        full = dict(cls.default_params())
        full.update(params)
        return (create_fn or (lambda c, a, **kw: c(a, **kw)))(
            cls, full, **kwargs)

    return build, register

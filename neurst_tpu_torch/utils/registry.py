"""Named registries (the port's own copy of
``neurst_tpu/utils/registry.py``).

``setup_registry(name)`` returns ``(build, register)``.  A registered
class is found by its class name, its snake_case form or any alias
(``get_registered_class``; every registry lives in ``REGISTRIES``, which
the flag parser walks).  ``build`` takes a name string, or a dict with
``{name}.class`` and ``{name}.params`` (or ``class`` / ``params``), fills
the defaults the class declares (``declared_defaults``) and calls
``create_fn``.
"""

import re
from typing import Callable, Dict, Optional

__all__ = ["REGISTRIES", "setup_registry", "get_registered_class",
           "declared_defaults", "camel_to_snake"]

REGISTRIES: Dict[str, Dict[str, type]] = {}


def camel_to_snake(name: str) -> str:
    s1 = re.sub(r"(.)([A-Z][a-z]+)", r"\1_\2", name)
    return re.sub(r"([a-z0-9])([A-Z])", r"\1_\2", s1).lower()


def get_registered_class(name_or_cls, registry_name: str):
    """The class registered under ``name_or_cls`` (exact, then
    lower-cased), a class as it is, or None."""
    if registry_name not in REGISTRIES:
        raise KeyError(f"Unknown registry: {registry_name}. "
                       f"Available: {sorted(REGISTRIES)}")
    if name_or_cls is None or isinstance(name_or_cls, type):
        return name_or_cls
    if not isinstance(name_or_cls, str):
        raise ValueError(f"Cannot lookup {registry_name} registry with "
                         f"{type(name_or_cls)}")
    registry = REGISTRIES[registry_name]
    return registry.get(name_or_cls) or registry.get(name_or_cls.lower())


def declared_defaults(cls) -> dict:
    """The defaults of the flags ``cls`` declares in
    ``class_or_method_args()`` (module flags excluded; none where it
    declares no flags)."""
    if not hasattr(cls, "class_or_method_args"):
        return {}
    return {f.name: f.default for f in cls.class_or_method_args()
            if not getattr(f, "is_module_flag", False)}


def setup_registry(registry_name: str, base_class=None,
                   create_fn: Optional[Callable] = None):
    registry = REGISTRIES.setdefault(registry_name, {})

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
        if args is None:
            return None
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
        if cls_name is None:
            return None
        cls = get_registered_class(cls_name, registry_name)
        if cls is None:
            raise LookupError(f"'{cls_name}' is not registered in "
                              f"'{registry_name}'. Known: {sorted(registry)}")
        full = declared_defaults(cls)
        full.update(params)
        return (create_fn or (lambda c, a, **kw: c(a, **kw)))(
            cls, full, **kwargs)

    return build, register

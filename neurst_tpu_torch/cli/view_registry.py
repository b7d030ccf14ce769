"""Lists the port's registries, a registry's classes, or one class's
flags (the port's copy of ``neurst_tpu/cli/view_registry.py``;
host-only).

Usage:
    python -m neurst_tpu_torch.cli.view_registry            # registries
    python -m neurst_tpu_torch.cli.view_registry model      # its classes
    python -m neurst_tpu_torch.cli.view_registry model transformer
    python -m neurst_tpu_torch.cli.view_registry hparams_set [NAME]
"""

import sys

import yaml

import neurst_tpu_torch  # noqa: F401 - fills the registries
from neurst_tpu_torch.utils.hparams_sets import (get_hyper_parameters,
                                                 registered_hparams_names)
from neurst_tpu_torch.utils.registry import REGISTRIES, get_registered_class


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("Available registries:")
        for name in sorted(REGISTRIES):
            print(f"  {name}  ({len(set(REGISTRIES[name].values()))} classes)")
        return
    registry_name = argv[0]
    if registry_name in ("hparams_set", "hparams_sets"):
        if len(argv) > 1:
            print(yaml.dump(get_hyper_parameters(argv[1])))
            return
        print("Registered hparams sets (parametric names like "
              "transformer_<d>_<e>e_<d>d resolve dynamically):")
        for name in registered_hparams_names():
            print(f"  {name}")
        return
    if registry_name not in REGISTRIES:
        print(f"Unknown registry '{registry_name}'. "
              f"Available: {sorted(REGISTRIES)}")
        sys.exit(1)
    if len(argv) == 1:
        classes = {}
        for alias, cls in REGISTRIES[registry_name].items():
            classes.setdefault(cls, []).append(alias)
        print(f"Registered '{registry_name}' classes:")
        for cls, aliases in classes.items():
            print(f"  {cls.__name__}: aliases={sorted(aliases)}")
        return
    cls = get_registered_class(argv[1], registry_name)
    if cls is None:
        print(f"'{argv[1]}' is not registered in '{registry_name}'")
        sys.exit(1)
    print(f"{cls.__name__} ({cls.__module__})")
    doc = (cls.__doc__ or "").strip()
    if doc:
        print(doc.split("\n")[0])
    if hasattr(cls, "class_or_method_args"):
        print("Flags:")
        for f in cls.class_or_method_args():
            if getattr(f, "is_module_flag", False):
                print(f"  --{f.name} (module: {f.module_name}, "
                      f"default={f.default})")
            else:
                print(f"  --{f.name} ({f.dtype}, default={f.default})"
                      f" : {f.help}")


if __name__ == "__main__":
    main()

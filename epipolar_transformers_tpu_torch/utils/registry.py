"""Decorator-based registry (equivalent of reference utils/registry.py:6-39).

The port's own copy of epipolar_transformers_tpu/utils/registry.py."""

from __future__ import annotations


class Registry(dict):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)

    def register(self, name, obj=None):
        if obj is not None:
            self._do_register(name, obj)
            return obj

        def decorator(fn):
            self._do_register(name, fn)
            return fn

        return decorator

    def _do_register(self, name, obj):
        if name in self:
            raise KeyError(f"{name!r} already registered")
        self[name] = obj

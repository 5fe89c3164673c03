"""The attribute dict of the JAX package's ``utils/config.py`` (the
reference's ``dnnlib.EasyDict``), the config container of the training
CLI."""

from __future__ import annotations

from typing import Any


class EasyDict(dict):
    """dict with attribute access. Universal config container."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        del self[name]

"""Generic name-based registries (a copy of the JAX package's `registry.py`,
so that recipes name models, predictors and correctors the same way)."""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional


class Registry:
    """A string-keyed registry with a decorator-style `register`."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Any] = {}

    def register(self, obj: Any = None, *, name: Optional[str] = None):
        def _do(o: Any):
            key = name if name is not None else getattr(o, "__name__", str(o))
            if key in self._entries:
                raise ValueError(f"{self.kind} registry already has an entry named {key!r}")
            self._entries[key] = o
            return o

        if obj is None:
            return _do
        return _do(obj)

    def get(self, name: str) -> Any:
        try:
            return self._entries[name]
        except KeyError:
            known = ", ".join(sorted(self._entries))
            raise KeyError(f"Unknown {self.kind} {name!r}. Registered: {known}") from None

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def names(self) -> Iterable[str]:
        return sorted(self._entries)


# The registries this port fills so far.
models = Registry("model")
predictors = Registry("predictor")
correctors = Registry("corrector")
trainables = Registry("trainable")
datamodules = Registry("datamodule")
callbacks = Registry("callback")

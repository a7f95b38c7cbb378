"""Port of ``src/repro/core/registry.py`` (copied verbatim; pure Python).

String-addressable component registry for the compression API.

Every pluggable piece of the gradient-sync pipeline — ``Compressor``,
``Transport``, ``DispatchPolicy``, ``Correction``, ``Schedule`` —
registers a factory
under a ``(kind, name)`` key so configs can name components by string
(``TrainConfig.optimizer = "threshold_bsearch"``) and extensions can add
new ones without touching core code:

    from repro_torch.core import registry

    @registry.register(registry.COMPRESSOR, "my_topk")
    class MyTopK: ...

    comp = registry.make(registry.COMPRESSOR, "my_topk", eps=0.1)

Specs support one level of composition with ``outer(inner)`` syntax —
``"quantized(trimmed_topk)"`` builds the inner compressor first and passes
it to the outer factory as the ``inner`` keyword (RedSync §5.2.3 wraps any
selector). Factories receive ``**params`` and must ignore keys they don't
consume, so one config bag can parameterize heterogeneous components.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable

COMPRESSOR = "compressor"
TRANSPORT = "transport"
DISPATCH_POLICY = "dispatch_policy"
CORRECTION = "correction"
SCHEDULE = "schedule"

_REGISTRY: dict[str, dict[str, Callable[..., Any]]] = {}


def register(kind: str, name: str) -> Callable[[Callable], Callable]:
    """Decorator: register ``factory`` under ``(kind, name)``.

    Re-registering a name overwrites (supports reload / test doubles).
    """
    def deco(factory: Callable) -> Callable:
        _REGISTRY.setdefault(kind, {})[name] = factory
        return factory
    return deco


def register_alias(kind: str, alias: str, name: str) -> None:
    """Expose an already-registered factory under a second name."""
    _REGISTRY.setdefault(kind, {})[alias] = _REGISTRY[kind][name]


def names(kind: str) -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY.get(kind, {})))


def contains(kind: str, spec: str) -> bool:
    try:
        parse(kind, spec)
        return True
    except KeyError:
        return False


def parse(kind: str, spec: str) -> tuple[Callable, str | None]:
    """``"name"`` or ``"outer(inner)"`` -> (outer factory, inner spec)."""
    spec = spec.strip()
    inner: str | None = None
    if spec.endswith(")") and "(" in spec:
        spec, _, rest = spec.partition("(")
        inner = rest[:-1].strip()
    table = _REGISTRY.get(kind, {})
    if spec not in table:
        raise KeyError(
            f"no {kind} named {spec!r}; registered: {names(kind)}")
    if inner is not None:                 # validate the inner spec eagerly
        parse(kind, inner)
    return table[spec], inner


def make(kind: str, spec: str, **params: Any) -> Any:
    """Build a component from a string spec, threading ``params`` through."""
    factory, inner = parse(kind, spec)
    if inner is not None:
        return factory(inner=make(kind, inner, **params), **params)
    return factory(**params)

"""Typed settings.

The reference's ``Settings`` (core/common/settings/Settings.java) is a flat
immutable string map with ad-hoc parsing at call sites; the typed ``Setting<T>``
registry only arrives in later ES versions. Per SURVEY.md §5 we do typed
settings from day one: a :class:`Setting` declares key, default, parser and
scope, and :class:`Settings` is the immutable value map.

Supports the reference's value syntaxes: byte sizes ("512mb"), time values
("30s"), booleans, and flat dotted keys with ``getAsInt``-style accessors.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Generic, Iterator, Mapping, TypeVar

from elasticsearch_tpu_torch.common.errors import IllegalArgumentError

T = TypeVar("T")

_TIME_UNITS = {
    "nanos": 1e-9, "micros": 1e-6, "ms": 1e-3, "s": 1.0,
    "m": 60.0, "h": 3600.0, "d": 86400.0,
}
_BYTE_UNITS = {
    "b": 1, "kb": 1024, "k": 1024, "mb": 1024**2, "m": 1024**2,
    "gb": 1024**3, "g": 1024**3, "tb": 1024**4, "t": 1024**4,
    "pb": 1024**5, "p": 1024**5,
}


def parse_time_value(value: Any, setting_name: str = "") -> float:
    """'30s' / '100ms' / number-of-millis → seconds (float)."""
    if isinstance(value, (int, float)):
        return float(value) / 1000.0
    s = str(value).strip().lower()
    m = re.fullmatch(r"(-?\d+(?:\.\d+)?)\s*([a-z]+)?", s)
    if not m:
        raise IllegalArgumentError(f"failed to parse time value [{value}] for [{setting_name}]")
    num, unit = float(m.group(1)), m.group(2) or "ms"
    if unit not in _TIME_UNITS:
        raise IllegalArgumentError(f"unknown time unit [{unit}] in [{value}]")
    return num * _TIME_UNITS[unit]


def parse_bytes_value(value: Any, setting_name: str = "") -> int:
    """'512mb' / '1g' / raw int → bytes."""
    if isinstance(value, int):
        return value
    s = str(value).strip().lower()
    m = re.fullmatch(r"(-?\d+(?:\.\d+)?)\s*([a-z]+)?", s)
    if not m:
        raise IllegalArgumentError(f"failed to parse bytes value [{value}] for [{setting_name}]")
    num, unit = float(m.group(1)), m.group(2) or "b"
    if unit not in _BYTE_UNITS:
        raise IllegalArgumentError(f"unknown bytes unit [{unit}] in [{value}]")
    return int(num * _BYTE_UNITS[unit])


def parse_bool(value: Any, setting_name: str = "") -> bool:
    if isinstance(value, bool):
        return value
    s = str(value).strip().lower()
    if s in ("true", "1", "on", "yes"):
        return True
    if s in ("false", "0", "off", "no"):
        return False
    raise IllegalArgumentError(f"failed to parse boolean [{value}] for [{setting_name}]")


class Setting(Generic[T]):
    """A typed setting declaration.

    ``scope`` is one of ``"node"``, ``"cluster"``, ``"index"``; ``dynamic``
    marks it updatable at runtime (the reference gates this through the
    ``DynamicSettings`` registry, core/cluster/settings/DynamicSettings.java:33).
    """

    REGISTRY: dict[str, "Setting"] = {}

    def __init__(
        self,
        key: str,
        default: T,
        parser: Callable[[Any], T] | None = None,
        *,
        scope: str = "node",
        dynamic: bool = False,
        validator: Callable[[T], None] | None = None,
    ):
        self.key = key
        self.default = default
        self.scope = scope
        self.dynamic = dynamic
        self.validator = validator
        if parser is not None:
            self.parser: Callable[[Any], T] = parser
        elif isinstance(default, bool):
            self.parser = lambda v: parse_bool(v, key)  # type: ignore[assignment]
        elif isinstance(default, int):
            self.parser = lambda v: int(v)  # type: ignore[assignment]
        elif isinstance(default, float):
            self.parser = lambda v: float(v)  # type: ignore[assignment]
        else:
            self.parser = lambda v: v  # type: ignore[assignment]
        Setting.REGISTRY[key] = self

    def get(self, settings: "Settings") -> T:
        raw = settings.get(self.key)
        if raw is None:
            return self.default
        value = self.parser(raw)
        if self.validator is not None:
            self.validator(value)
        return value

    @staticmethod
    def time_setting(key: str, default_seconds: float, **kw) -> "Setting[float]":
        return Setting(key, default_seconds, lambda v: parse_time_value(v, key), **kw)

    @staticmethod
    def bytes_setting(key: str, default_bytes: int, **kw) -> "Setting[int]":
        return Setting(key, default_bytes, lambda v: parse_bytes_value(v, key), **kw)


class Settings(Mapping[str, Any]):
    """Immutable flat key→value map with dotted keys.

    Nested dict inputs are flattened (``{"index": {"number_of_shards": 2}}`` →
    ``index.number_of_shards``), matching the reference's yaml loading
    (core/common/settings/loader/)."""

    EMPTY: "Settings"

    def __init__(self, values: Mapping[str, Any] | None = None):
        self._map: dict[str, Any] = {}
        if values:
            self._flatten("", values)

    def _flatten(self, prefix: str, values: Mapping[str, Any]) -> None:
        for k, v in values.items():
            key = f"{prefix}{k}"
            if isinstance(v, Mapping):
                self._flatten(key + ".", v)
            else:
                self._map[key] = v

    # Mapping interface
    def __getitem__(self, key: str) -> Any:
        return self._map[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._map)

    def __len__(self) -> int:
        return len(self._map)

    def get(self, key: str, default: Any = None) -> Any:
        return self._map.get(key, default)

    # getAs* accessors (Settings.java getAsInt/getAsBoolean/getAsTime/...)
    def get_as_int(self, key: str, default: int) -> int:
        v = self.get(key)
        return default if v is None else int(v)

    def get_as_float(self, key: str, default: float) -> float:
        v = self.get(key)
        return default if v is None else float(v)

    def get_as_bool(self, key: str, default: bool) -> bool:
        v = self.get(key)
        return default if v is None else parse_bool(v, key)

    def get_as_time(self, key: str, default_seconds: float) -> float:
        v = self.get(key)
        return default_seconds if v is None else parse_time_value(v, key)

    def get_as_bytes(self, key: str, default_bytes: int) -> int:
        v = self.get(key)
        return default_bytes if v is None else parse_bytes_value(v, key)

    def get_by_prefix(self, prefix: str) -> "Settings":
        s = Settings()
        s._map = {k[len(prefix):]: v for k, v in self._map.items() if k.startswith(prefix)}
        return s

    def as_dict(self) -> dict[str, Any]:
        return dict(self._map)

    def merge(self, other: "Settings | Mapping[str, Any] | None") -> "Settings":
        """Right-biased merge → new Settings."""
        s = Settings()
        s._map = dict(self._map)
        if other is None:
            return s
        if isinstance(other, Settings):
            s._map.update(other._map)
        else:
            s._flatten("", other)
        return s

    def __repr__(self) -> str:
        return f"Settings({self._map!r})"


Settings.EMPTY = Settings()


def parse_time_millis(v) -> int:
    """'100ms' / '30s' / '1m' / '2h' / bare number → milliseconds
    (TimeValue.parseTimeValue, core/common/unit/TimeValue.java)."""
    s = str(v)
    for suffix, mult in (("ms", 1), ("s", 1000), ("m", 60000),
                         ("h", 3600000), ("d", 86400000)):
        if s.endswith(suffix):
            return int(float(s[:-len(suffix)]) * mult)
    return int(float(s))


def source_from_path(src, path: str):
    """Dotted-path value extraction from a source dict (stored fields)."""
    if not isinstance(src, dict):
        return None
    v = src.get(path)
    if v is None and "." in path:
        node = src
        for part in path.split("."):
            node = node.get(part) if isinstance(node, dict) else None
            if node is None:
                return None
        v = node
    return v

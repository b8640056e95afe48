"""Version identity for wire/index compatibility.

The reference threads a ``Version`` through every serialized stream so nodes
of different releases interoperate during rolling upgrades
(core/common/io/stream/StreamInput.java:58, core/Version.java). We keep the
same contract: every persisted artifact (segment metadata, translog header,
cluster metadata) records the :data:`CURRENT_VERSION` ``id`` and readers check
compatibility before decoding.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True, order=True)
class Version:
    id: int  # XXYYZZ, e.g. 1_00_00
    major: int
    minor: int
    revision: int

    @staticmethod
    def from_id(vid: int) -> "Version":
        return Version(vid, vid // 10000, (vid // 100) % 100, vid % 100)

    def __str__(self) -> str:
        return f"{self.major}.{self.minor}.{self.revision}"

    def on_or_after(self, other: "Version") -> bool:
        return self.id >= other.id

    def before(self, other: "Version") -> bool:
        return self.id < other.id

    def is_compatible(self, other: "Version") -> bool:
        """Same major = wire/index compatible (reference rolling-upgrade rule)."""
        return self.major == other.major


V_0_1_0 = Version.from_id(100)
CURRENT_VERSION = V_0_1_0

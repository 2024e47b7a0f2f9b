"""The comparison that decides ``correct``.

After the window closes the harness hands over what the program
produced: each GET's payload digest (the sha256 the gateway records for
the bytes it served), each PUT's acknowledgement, the read-back of
every object a PUT wrote, the stored blocks of every group a PUT
touched and the final bytes of every block a lost disk took. The plain
reference (``portbench/reference``) works the expected bytes out again
from the inputs the harness made: the seeded objects, the objects and
simulated times of the PUTs, and the configuration's code.

Every number compared is a count of wrong or missing answers, and each
limit is 0: the store's guarantees are exact.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np
import torch

from portbench.reference.code import CoreCode
from portbench.reference.payload import put_payload


@dataclass
class Evidence:
    """What the program produced, taken after the window."""

    gets: list[tuple[int, float, str | None]] = field(default_factory=list)
    puts: list[tuple[int, float, bool]] = field(default_factory=list)
    readback: list[tuple[int, float, str | None]] = field(default_factory=list)
    # (group, row, col) -> stored bytes, None where the block is unavailable
    blocks: dict = field(default_factory=dict)
    lost: dict = field(default_factory=dict)


class Reference:
    """Expected object versions and group matrices of one run."""

    def __init__(self, config: dict, objects: np.ndarray, puts, device: str):
        code = config["code"]
        self.code = CoreCode.from_config(code)
        self.k, self.t = code["k"], code["t"]
        self.q = config["block_bytes"]
        self.objects = objects
        self.device = device
        self.writes: dict[int, list[float]] = {}
        for oid, sim_time, _acked in puts:
            self.writes.setdefault(oid, []).append(sim_time)
        for times in self.writes.values():
            times.sort()
        self._digests: dict = {}

    def version(self, oid: int, before: float = float("inf")) -> float | None:
        """Simulated time of the last write of ``oid`` before ``before``
        (None: the seeded bytes)."""
        times = [t for t in self.writes.get(oid, ()) if t < before]
        return times[-1] if times else None

    def data(self, oid: int, version: float | None) -> np.ndarray:
        if version is None:
            return self.objects[oid]
        return put_payload(oid, version, self.k, self.q)

    def digest(self, oid: int, version: float | None) -> str:
        key = (oid, version)
        if key not in self._digests:
            self._digests[key] = hashlib.sha256(
                np.ascontiguousarray(self.data(oid, version))).hexdigest()
        return self._digests[key]

    def group(self, gid: str) -> torch.Tensor:
        """The (t + 1, n, q) matrix of group ``gid`` over its last writes;
        objects are packed t to a group in id order."""
        first = int(gid[1:]) * self.t
        objs = np.stack([self.data(o, self.version(o)) for o in range(first, first + self.t)])
        return self.code.encode_group(torch.from_numpy(objs).to(self.device))


def compare(config: dict, objects: np.ndarray, ev: Evidence, device: str,
            kinds: set[str], losses: bool) -> dict[str, tuple[int, int]]:
    """{name: (value, limit)} for the checks this cell's traffic calls for."""
    ref = Reference(config, objects, ev.puts, device)
    out: dict[str, tuple[int, int]] = {}
    if "get" in kinds:
        served = [(o, s, d) for o, s, d in ev.gets if d is not None]
        out["get_missing"] = (len(ev.gets) - len(served), 0)
        out["get_wrong"] = (sum(d != ref.digest(o, ref.version(o, s)) for o, s, d in served), 0)
    if "put" in kinds:
        out["put_missing"] = (sum(not acked for _o, _s, acked in ev.puts), 0)
        out["readback_wrong"] = (
            sum(d is None or d != ref.digest(o, ref.version(o)) for o, _s, d in ev.readback)
            + len({o for o, _s, _a in ev.puts} - {o for o, _s, _d in ev.readback}), 0)
        out["parity_wrong"] = (_wrong_blocks(ref, ev.blocks), 0)
    if losses:
        out["repair_missing"] = (sum(blk is None for blk in ev.lost.values()), 0)
        out["repair_wrong"] = (_wrong_blocks(ref, ev.lost), 0)
    return out


def _wrong_blocks(ref: Reference, blocks: dict) -> int:
    """Stored blocks that differ from the reference's; unavailable ones
    (None) are left to the missing counts."""
    wrong = 0
    for gid in sorted({key[0] for key in blocks}):
        want = ref.group(gid)
        for (g, r, c), got in blocks.items():
            if g != gid:
                continue
            if got is None:
                continue
            if not torch.equal(want[r, c], torch.from_numpy(np.asarray(got)).to(want.device)):
                wrong += 1
        del want
    return wrong

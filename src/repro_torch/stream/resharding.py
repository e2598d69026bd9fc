"""Versioned gid routing + live shard split/merge under traffic.

The :class:`~repro_torch.stream.sharded.HashRouter` maps ``gid -> shard`` with
one fixed modulus -- growing the shard count means re-hashing the world.
:class:`VersionedRouter` decouples placement from the shard count with
the classic two-level scheme: gids hash onto a fixed ring of *slots*
(default 64) and a **versioned** ``slot -> shard`` assignment maps slots
to owners.  Resharding then never re-hashes anything: ``split_shard``
moves half of one shard's slots to a fresh shard, ``merge_shards`` moves
all of one shard's slots onto another, and only the points in the moved
slots migrate.  Every assignment change bumps ``version`` -- the
epoch-vector machinery extended to placement: a pinned snapshot carries
the router version it was routed under, the serving layer reports it,
and the lambda cache's shard-layout staleness check (epoch-vector length
mismatch) invalidates warm caps across a split/merge automatically.

Migration state machine (journaled; see ``MigrationJournal``)::

    prepare:  new assignment computed and journaled (atomic JSON + an
              OP_ROUTER record in both shards' WALs) *before* it is
              adopted -- the journal is what recovery trusts, so it
              must be durable before the new map can route (and ack) a
              single write.  Then the version bumps and new writes for
              moved slots route to the destination; deletes
              double-resolve (new owner, then the journaled previous
              owner); queries already fan over every shard and
              ``merge_topk`` de-duplicates by gid, so a point
              momentarily visible in both owners is harmless.
    copy:     moved live rows stream src -> dst in bounded batches under
              the migration lock (insert into dst *before* delete from
              src -- a crash between the two leaves a duplicate, never a
              loss; duplicates are swept by recovery).  Each batch is
              ordinary routed writes, so both shards' WALs journal it.
    done:     journal marked done (atomic JSON + OP_ROUTER records).

Crash recovery (``recover_migration``): a journal not marked done means
the crash hit mid-migration.  The new assignment is already durable (the
journal is written atomically before any data moves), so recovery adopts
it, deletes src copies of gids now present in both owners (the
crash-between-insert-and-delete window), finishes the copy loop for
anything still stranded in src, and marks the journal done -- the map is
consistent and every live gid has exactly one owner again.

Router specs, the journal's JSON and its ``OP_ROUTER`` WAL payload are the
JAX package's byte for byte: either package reads the other's files.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

__all__ = ["VersionedRouter", "MigrationJournal", "plan_split",
           "plan_merge"]

# same multiplicative hash as HashRouter: decorrelates sequential gids
_HASH_MULT = 2654435761
DEFAULT_SLOTS = 64


class VersionedRouter:
    """Slot-ring router with a versioned slot -> shard assignment."""

    kind = "versioned"

    def __init__(self, num_shards: int | None = None, *,
                 num_slots: int = DEFAULT_SLOTS,
                 assignment: tuple | None = None, version: int = 0):
        self.num_slots = int(num_slots)
        if assignment is not None:
            self.assignment = tuple(int(s) for s in assignment)
            assert len(self.assignment) == self.num_slots
        else:
            assert num_shards is not None and num_shards >= 1
            # num_shards | num_slots keeps the identity assignment
            # bit-compatible with HashRouter's hash % num_shards
            assert self.num_slots % num_shards == 0, \
                (num_shards, self.num_slots)
            self.assignment = tuple(s % num_shards
                                    for s in range(self.num_slots))
        self.version = int(version)
        #: slot -> previous owner while a migration is in flight (the
        #: double-resolve window for deletes/lookups)
        self.moving: dict[int, int] = {}

    # ------------------------------------------------------------------
    @property
    def num_shards(self) -> int:
        return max(self.assignment) + 1

    def slot_of(self, gid: int) -> int:
        return ((int(gid) * _HASH_MULT) & 0xFFFFFFFF) % self.num_slots

    def slot_of_many(self, gids) -> np.ndarray:
        g = np.asarray(gids).astype(np.uint64)
        return (((g * np.uint64(_HASH_MULT)) & np.uint64(0xFFFFFFFF))
                % np.uint64(self.num_slots)).astype(np.int32)

    def shard_of(self, gid: int) -> int:
        return self.assignment[self.slot_of(gid)]

    def shard_of_many(self, gids) -> np.ndarray:
        table = np.asarray(self.assignment, np.int32)
        return table[self.slot_of_many(gids)]

    def prev_shard_of(self, gid: int) -> int | None:
        """The slot's previous owner while it is migrating, else None --
        the second stop of a double-resolved delete."""
        return self.moving.get(self.slot_of(gid))

    # ------------------------------------------------------------------
    def apply(self, new_assignment, moving: dict | None = None) -> None:
        """Adopt a new assignment (version bump).  ``moving`` is the
        in-flight ``slot -> previous owner`` map (empty = migration
        complete)."""
        new_assignment = tuple(int(s) for s in new_assignment)
        assert len(new_assignment) == self.num_slots
        self.assignment = new_assignment
        self.version += 1
        self.moving = dict(moving or {})

    def spec(self) -> dict:
        return {"kind": self.kind, "num_slots": self.num_slots,
                "assignment": list(self.assignment),
                "version": self.version}

    @classmethod
    def from_spec(cls, spec: dict) -> "VersionedRouter":
        assert spec.get("kind") == cls.kind, spec
        return cls(num_slots=spec["num_slots"],
                   assignment=spec["assignment"],
                   version=spec.get("version", 0))

    @classmethod
    def from_hash_spec(cls, spec: dict,
                       num_slots: int = DEFAULT_SLOTS) -> "VersionedRouter":
        """Upgrade a HashRouter spec in place: the identity assignment
        over a slot count the shard count divides routes every gid to
        the same shard the hash router did."""
        return cls(spec["num_shards"], num_slots=num_slots)


# ----------------------------------------------------------------------
# migration planning
# ----------------------------------------------------------------------
def plan_split(router: VersionedRouter, shard: int,
               new_shard: int) -> tuple[tuple, dict]:
    """New assignment moving half of ``shard``'s slots to ``new_shard``;
    returns ``(assignment, moving)`` with ``moving = {slot: shard}``."""
    owned = [s for s, o in enumerate(router.assignment) if o == shard]
    if len(owned) < 2:
        raise ValueError(
            f"shard {shard} owns {len(owned)} slot(s); cannot split -- "
            "raise num_slots")
    moved = owned[len(owned) // 2:]
    assignment = list(router.assignment)
    for s in moved:
        assignment[s] = new_shard
    return tuple(assignment), {s: shard for s in moved}


def plan_merge(router: VersionedRouter, src: int,
               dst: int) -> tuple[tuple, dict]:
    """New assignment moving *all* of ``src``'s slots onto ``dst``."""
    if src == dst:
        raise ValueError("merge requires distinct shards")
    moved = [s for s, o in enumerate(router.assignment) if o == src]
    if not moved:
        raise ValueError(f"shard {src} owns no slots")
    assignment = list(router.assignment)
    for s in moved:
        assignment[s] = dst
    return tuple(assignment), {s: src for s in moved}


# ----------------------------------------------------------------------
# migration journal
# ----------------------------------------------------------------------
@dataclasses.dataclass
class MigrationJournal:
    """Crash-safe record of one in-flight slot migration.

    Persisted with the checkpoint manifest's atomicity discipline
    (fsync'd tmp + rename + parent-dir fsync) at every phase
    transition, and mirrored as ``OP_ROUTER`` records into the
    participating shards' WALs.  ``phase`` is ``"copy"`` (data moving)
    or ``"done"``; recovery treats anything not ``done`` as mid-flight.
    """

    src: int
    dst: int
    moved_slots: tuple
    assignment: tuple  # the post-migration (already-adopted) assignment
    version: int       # router version of that assignment
    phase: str = "copy"
    op: str = "split"  # "split" | "merge" (diagnostic only)

    FILENAME = "MIGRATION.json"

    def to_spec(self) -> dict:
        return {"src": self.src, "dst": self.dst,
                "moved_slots": list(self.moved_slots),
                "assignment": list(self.assignment),
                "version": self.version, "phase": self.phase,
                "op": self.op}

    @classmethod
    def from_spec(cls, spec: dict) -> "MigrationJournal":
        return cls(src=spec["src"], dst=spec["dst"],
                   moved_slots=tuple(spec["moved_slots"]),
                   assignment=tuple(spec["assignment"]),
                   version=spec["version"], phase=spec["phase"],
                   op=spec.get("op", "split"))

    # ------------------------------------------------------------------
    def write(self, directory: str) -> None:
        from repro_torch.checkpoint.manager import write_json_atomic

        write_json_atomic(os.path.join(directory, self.FILENAME),
                          self.to_spec())

    @classmethod
    def read(cls, directory: str) -> "MigrationJournal | None":
        path = os.path.join(directory, cls.FILENAME)
        if not os.path.exists(path):
            return None
        with open(path) as fh:
            return cls.from_spec(json.load(fh))

    @classmethod
    def clear(cls, directory: str) -> None:
        path = os.path.join(directory, cls.FILENAME)
        if os.path.exists(path):
            os.remove(path)

    def wal_blob(self) -> bytes:
        """The journal as an ``OP_ROUTER`` WAL payload (belt to the
        atomic-JSON suspenders: either survives a torn crash)."""
        return json.dumps(self.to_spec()).encode()

"""Kill-and-recover chaos round for the port's sharded index.

The write-ahead log's contract is recovery to the last acknowledged write:
an op whose acknowledgement came back must survive a SIGKILL, anything
later may be lost.  One round checks that with a real process kill:

  * the **child** (this file run as a script) opens a durable sharded index
    (``ShardedMutableP2HIndex.open`` on the host) and runs an endless
    insert/delete storm.  Its ``on_ack`` callback appends one line per
    acknowledged op to ``acked.log`` (line-buffered: the bytes reach the OS
    page cache, which survives SIGKILL) and then the acknowledging shard's
    epoch; a delete *attempt* is logged before it is issued (its record may
    become durable without its acknowledgement coming back).
    ``--save-every`` checkpoints every so many iterations.
  * the **parent** (:func:`kill_round`) SIGKILLs the child as soon as the
    ack log holds ``min_acks`` new lines -- a gate on the ack count, not on
    a clock -- waiting at most ``timeout_s`` for them.  It then recovers
    (``open`` under ``run_with_restarts``) and counts acknowledged inserts
    lost, gids owned by two shards, acknowledged deletes resurrected and
    shards whose epoch went back below the epoch they had when they last
    acknowledged a write.  One acknowledgement comes from one shard's log
    and covers every op that shard applied so far, so that epoch is one of
    acknowledged state; the epoch *vector* at an acknowledgement is not
    (another shard may hold a write still waiting for its group commit,
    which a kill may drop).

Rounds run back to back against one directory, so each child resumes from
the previous round's state.  The child never imports JAX.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np

ACK_LOG = "acked.log"
_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_HERE), "src")


def _child(args) -> None:
    from repro_torch.stream import ShardedMutableP2HIndex, WalConfig

    rng = np.random.default_rng(args.seed)
    state = {"idx": None}
    path = os.path.join(args.dir, ACK_LOG)
    torn = False
    if os.path.exists(path) and os.path.getsize(path):
        with open(path, "rb") as fh:
            fh.seek(-1, os.SEEK_END)
            torn = fh.read(1) != b"\n"
    ack_fh = open(path, "a", buffering=1)
    if torn:  # end the killed incarnation's torn line; it parses as junk
        ack_fh.write("#\n")

    def on_ack(tokens):
        for kind, gid in tokens:
            ack_fh.write(f"{kind} {gid}\n")
        idx = state["idx"]
        if idx is not None and tokens:  # one shard's log acknowledged
            s = idx.router.shard_of(tokens[0][1])
            ack_fh.write(f"E {s} {idx.shards[s].epoch}\n")

    idx = ShardedMutableP2HIndex.open(
        args.dir, dim=args.dim, num_shards=args.shards, device="cpu",
        wal_config=WalConfig(fsync_every_n=args.fsync_every_n,
                             fsync_interval_ms=5.0),
        on_ack=on_ack)
    state["idx"] = idx
    issued: list[int] = []
    it = 0
    while True:  # until SIGKILL
        pts = rng.normal(size=(args.batch, args.dim)).astype(np.float32)
        issued += [int(g) for g in idx.insert_batch(pts)]
        if issued and rng.random() < 0.4:
            gid = issued.pop(int(rng.integers(len(issued))))
            ack_fh.write(f"d? {gid}\n")  # the attempt, before the op
            idx.delete(gid)
        it += 1
        if args.save_every and it % args.save_every == 0:
            idx.save(args.dir)  # checkpoint + log prefix truncation


def read_ack_log(path: str):
    """``(acked inserts, acked deletes, delete attempts, {shard: epoch at its
    last acknowledgement})``; a final line the kill tore (no newline) is
    dropped."""
    acked_ins, acked_del, attempted = set(), set(), set()
    last_epochs = {}
    if not os.path.exists(path):
        return acked_ins, acked_del, attempted, last_epochs
    with open(path, "rb") as fh:
        lines = fh.read().split(b"\n")
    for raw in lines[:-1]:  # the part after the last newline is torn
        parts = raw.decode("utf-8", "replace").split()
        try:
            if parts[0] == "ins":
                acked_ins.add(int(parts[1]))
            elif parts[0] == "del":
                acked_del.add(int(parts[1]))
            elif parts[0] == "d?":
                attempted.add(int(parts[1]))
            elif parts[0] == "E":
                last_epochs[int(parts[1])] = int(parts[2])
        except (IndexError, ValueError):
            continue  # a torn line a later incarnation ended with "#"
    return acked_ins, acked_del, attempted, last_epochs


def _ack_lines(path: str) -> int:
    if not os.path.exists(path):
        return 0
    with open(path, "rb") as fh:
        return fh.read().count(b"\n")


def kill_round(directory: str, *, dim: int, shards: int, seed: int,
               min_acks: int, save_every: int, fsync_every_n: int = 4,
               batch: int = 4, timeout_s: float = 240.0) -> dict:
    """One round: storm, SIGKILL once ``min_acks`` new acknowledgements
    are logged, recover, count the four invariants' violations."""
    from repro_torch.runtime import RetryPolicy, run_with_restarts
    from repro_torch.stream import ShardedMutableP2HIndex

    ack_path = os.path.join(directory, ACK_LOG)
    baseline = _ack_lines(ack_path)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_SRC] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dir", directory,
         "--dim", str(dim), "--shards", str(shards), "--seed", str(seed),
         "--save-every", str(save_every), "--fsync-every-n",
         str(fsync_every_n), "--batch", str(batch)],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    t0 = time.monotonic()
    try:
        while _ack_lines(ack_path) - baseline < min_acks:
            if proc.poll() is not None:  # died on its own: a bug
                err = proc.stderr.read().decode("utf-8", "replace")
                raise RuntimeError(f"storm child exited rc={proc.returncode}"
                                   f" before the kill: {err[-2000:]}")
            if time.monotonic() - t0 > timeout_s:
                raise TimeoutError(f"the child logged fewer than {min_acks} "
                                   f"acknowledgements in {timeout_s} s")
            time.sleep(0.01)
    finally:
        proc.kill()  # SIGKILL, mid-storm
        proc.wait(timeout=60)
        proc.stderr.close()
    if proc.returncode >= 0:
        raise RuntimeError(f"the child was not killed: rc={proc.returncode}")

    acked_ins, acked_del, attempted, last_epochs = read_ack_log(ack_path)
    t1 = time.monotonic()
    idx, restarts = run_with_restarts(
        lambda: ShardedMutableP2HIndex.open(directory, dim=dim,
                                            num_shards=shards, device="cpu"),
        lambda ix: ix, policy=RetryPolicy(max_restarts=2))
    recovery_s = time.monotonic() - t1
    per_shard = [set(int(g) for g in sh.live_gids()) for sh in idx.shards]
    live = set().union(*per_shard)
    epochs = tuple(idx.epoch)
    result = {
        "acked_ops": len(acked_ins) + len(acked_del),
        "recovery_s": recovery_s,
        "restarts": restarts,
        # an acked insert may be missing only if a delete was attempted
        "acked_loss": len(acked_ins - attempted - live),
        "dup_gids": sum(len(s) for s in per_shard) - len(live),
        "resurrected": len(live & acked_del),
        "epoch_regressions": sum(1 for s, e in last_epochs.items()
                                 if epochs[s] < e),
        "live_count": len(live),
        "misroutes": idx.stats()["misroutes"],
    }
    if live:  # the recovered index serves its survivors
        q = np.zeros((1, dim + 1), np.float32)
        q[0, 0] = 1.0
        _, ids = idx.query(q, min(4, len(live)))
        assert set(ids.ravel().tolist()) <= live
    idx.close()
    return result


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", required=True)
    ap.add_argument("--dim", type=int, default=8)
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save-every", type=int, default=0)
    ap.add_argument("--fsync-every-n", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    _child(ap.parse_args())

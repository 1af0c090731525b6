"""Filesystem job queue for cloud-burst processing.

The port's own copy of ``deploy/cloud/jobqueue.py`` (the package imports
nothing outside itself), with the on-disk protocol unchanged, so that
workers of the JAX package and of this port can drain one queue together.
The reference pyDEM's cloud story is an object-storage-triggered function
per tile (``aws/handler.py``); here one *job* is one tile directory /
region processed end to end with ``ProcessManager(resume=True)``, so a
preempted worker loses at most one stage (in memory) or one super-block
visit (out of core).

Protocol (any shared filesystem: persistent disk, NFS, or a FUSE-mounted
bucket):

- ``<queue>/jobs/<name>.json``            pending job spec
- ``<queue>/jobs/<name>.json.claimed-*``  claimed (atomic rename); the
  claim file carries the worker id + heartbeat mtimes
- ``<queue>/jobs/<name>.json.done``       completed (result summary inside)
- ``<queue>/jobs/<name>.json.failed``     failed (traceback inside)

Claims are leases: a claim whose heartbeat is older than ``lease_s`` is
re-queued by any other worker (the preemption story: no coordinator
process exists).
"""
from __future__ import annotations

import json
import os
import socket
import time

JOBS = "jobs"


def _jobs_dir(queue):
    d = os.path.join(queue, JOBS)
    os.makedirs(d, exist_ok=True)
    return d


def submit(queue, name, spec):
    """Enqueue one job (idempotent: existing pending/done specs win)."""
    d = _jobs_dir(queue)
    fn = os.path.join(d, name + ".json")
    if any(os.path.exists(fn + suf) for suf in ("", ".done", ".failed")) \
            or _claim_of(d, name):
        return False
    tmp = fn + ".tmp-%d" % os.getpid()
    with open(tmp, "w") as f:
        json.dump(spec, f, indent=1)
    os.rename(tmp, fn)
    return True


def _claim_of(d, name):
    pre = name + ".json.claimed-"
    for fn in os.listdir(d):
        if fn.startswith(pre):
            return os.path.join(d, fn)
    return None


def worker_id():
    return "%s-%d" % (socket.gethostname(), os.getpid())


def claim_next(queue, lease_s=600):
    """Claim one job: first a pending spec, else a stale (expired-lease)
    claim.  Returns (name, spec, claim_path) or None."""
    d = _jobs_dir(queue)
    me = worker_id()
    names = sorted(fn[:-5] for fn in os.listdir(d) if fn.endswith(".json"))
    for name in names:
        src = os.path.join(d, name + ".json")
        dst = src + ".claimed-" + me
        try:
            os.rename(src, dst)  # atomic on one filesystem
        except OSError:
            continue
        with open(dst) as f:
            return name, json.load(f), dst
    # stale-claim recovery (preempted workers)
    now = time.time()
    for fn in sorted(os.listdir(d)):
        if ".json.claimed-" not in fn:
            continue
        path = os.path.join(d, fn)
        try:
            age = now - os.path.getmtime(path)
        except OSError:
            continue
        if age <= lease_s:
            continue
        name = fn.split(".json.claimed-")[0]
        dst = os.path.join(d, name + ".json.claimed-" + me)
        try:
            os.rename(path, dst)
        except OSError:
            continue
        os.utime(dst)
        with open(dst) as f:
            return name, json.load(f), dst
    return None


def heartbeat(claim_path):
    try:
        os.utime(claim_path)
    except OSError:
        pass


def finish(claim_path, result=None, error=None):
    name_json = claim_path.split(".claimed-")[0]
    out = name_json + (".failed" if error else ".done")
    with open(out, "w") as f:
        json.dump({"worker": worker_id(),
                   "finished": time.time(),
                   "result": result, "error": error}, f, indent=1)
    os.remove(claim_path)


def status(queue):
    d = _jobs_dir(queue)
    out = {"pending": [], "claimed": [], "done": [], "failed": []}
    for fn in sorted(os.listdir(d)):
        if fn.endswith(".json"):
            out["pending"].append(fn[:-5])
        elif ".json.claimed-" in fn:
            out["claimed"].append(fn.split(".json.claimed-")[0])
        elif fn.endswith(".done"):
            out["done"].append(fn[: -len(".json.done")])
        elif fn.endswith(".failed"):
            out["failed"].append(fn[: -len(".json.failed")])
    return out

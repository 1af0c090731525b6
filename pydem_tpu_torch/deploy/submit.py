"""Enqueue pydem_tpu_torch jobs and (optionally) run local workers.

Counterpart of ``deploy/cloud/submit.py``, with its job names
(``<basename>-<crc32 of the region's absolute path>``), flags and specs:
each job is a region (tile directory) processed end to end with resume;
the queue is plain files on shared storage (:mod:`.jobqueue`); workers are
``python -m pydem_tpu_torch.deploy.worker`` processes on GPU VMs, or local
processes via ``--local-workers``.

``--device`` goes through to the workers.  With ``--device cuda`` and
several visible cards, local worker k takes ``cuda:{k mod cards}``: one
worker a card, as one worker a TPU VM.  Local workers start with
``subprocess.Popen`` (fork and exec: no child inherits a CUDA context);
this process never initialises CUDA.  Enqueueing alone needs no device.

Examples::

  # enqueue every region under /data/regions/* and drain with one local
  # worker per card
  python -m pydem_tpu_torch.deploy.submit --queue /data/q /data/regions/* \\
      --export-root /data/out --local-workers 4

  # enqueue only; GPU VMs run the worker against the same queue
  python -m pydem_tpu_torch.deploy.submit --queue /data/q /data/regions/* \\
      --out-of-core

  # queue status
  python -m pydem_tpu_torch.deploy.submit --queue /data/q --status
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import zlib

from . import jobqueue as q


def job_name(region):
    """The job name of a region directory, as the JAX submit names it."""
    region = os.path.abspath(region)
    return "%s-%08x" % (os.path.basename(region.rstrip("/")),
                        zlib.crc32(region.encode()))


def worker_devices(device, n_workers):
    """The device of each local worker: ``cuda`` spreads the workers over
    the visible cards (worker k on ``cuda:{k mod cards}``); any other
    device, an indexed card or ``cpu``, is every worker's.  Raises when
    ``cuda`` is asked for and no card is visible."""
    if device != "cuda":
        return [device] * n_workers
    import torch

    cards = torch.cuda.device_count()  # NVML: creates no CUDA context
    if cards < 1:
        raise RuntimeError("submit --device cuda: no CUDA device is visible "
                           "(--device cpu runs the workers on the CPU)")
    return ["cuda:%d" % (k % cards) for k in range(n_workers)]


def worker_commands(queue, n_workers, device, lease):
    """The command line of each local worker."""
    return [[sys.executable, "-m", "pydem_tpu_torch.deploy.worker",
             "--queue", queue, "--drain", "--lease", str(lease),
             "--device", dev]
            for dev in worker_devices(device, n_workers)]


def main(argv=None):
    ap = argparse.ArgumentParser(description="pydem_tpu_torch cloud-burst "
                                             "submit")
    ap.add_argument("--queue", required=True)
    ap.add_argument("regions", nargs="*",
                    help="tile directories, one job each")
    ap.add_argument("--export-root", default=None,
                    help="write GeoTIFF exports under <root>/<job name>")
    ap.add_argument("--out-of-core", action="store_true")
    ap.add_argument("--superblock", type=int, default=None)
    ap.add_argument("--dem-proc-kwargs", default=None,
                    help="JSON dict forwarded to DEMProcessor")
    ap.add_argument("--local-workers", type=int, default=0,
                    help="run N worker processes to drain the queue "
                         "(dev/test mode; VMs run the worker themselves)")
    ap.add_argument("--device", default="cuda",
                    help="the local workers' torch device (default cuda: "
                         "one worker a card; --device cpu for the CPU)")
    ap.add_argument("--lease", type=int, default=600)
    ap.add_argument("--status", action="store_true")
    ap.add_argument("--debug-unit-pixels", action="store_true",
                    help=argparse.SUPPRESS)  # test hook (manager._debug)
    args = ap.parse_args(argv)

    if args.status:
        print(json.dumps(q.status(args.queue), indent=1))
        return 0

    n_new = 0
    for region in args.regions:
        name = job_name(region)
        spec = {"in_path": os.path.abspath(region),
                "out_of_core": bool(args.out_of_core)}
        if args.superblock:
            spec["superblock"] = args.superblock
        if args.export_root:
            spec["export"] = os.path.join(args.export_root, name)
        if args.dem_proc_kwargs:
            spec["dem_proc_kwargs"] = json.loads(args.dem_proc_kwargs)
        if args.debug_unit_pixels:
            spec["_debug"] = True
        n_new += bool(q.submit(args.queue, name, spec))
    print("enqueued %d job(s); queue: %s"
          % (n_new, json.dumps({k: len(v)
                                for k, v in q.status(args.queue).items()})),
          flush=True)

    if args.local_workers:
        cmds = worker_commands(args.queue, args.local_workers, args.device,
                               args.lease)
        # the workers import this package from the checkout it runs from
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (root, env.get("PYTHONPATH")) if p)
        procs = [subprocess.Popen(cmd, env=env) for cmd in cmds]
        rc = 0
        for p in procs:
            rc |= p.wait()
        print(json.dumps(q.status(args.queue), indent=1), flush=True)
        return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())

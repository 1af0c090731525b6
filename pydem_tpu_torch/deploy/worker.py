"""Cloud-burst worker: claim jobs from the queue, run the pipeline on the
card, exit when drained.

Counterpart of ``deploy/cloud/worker.py`` for GPU VMs: start one of these
per card (an instance template or a service manager restarts it on boot),
point ``--queue`` at shared durable storage, and preemption costs at most
one stage / super-block visit (``resume=True`` everywhere).  The queue is
:mod:`.jobqueue`, whose files are those of the JAX worker's queue.

Job spec fields (see :mod:`.submit`), as the JAX worker reads them:
  in_path          tile directory
  out_path         store path (default <in_path>/results.zarr)
  export           optional GeoTIFF export directory
  out_of_core      bool; super-block size via "superblock"
  dem_proc_kwargs  forwarded DEMProcessor options
  _debug           unit pixel sizes (test hook, ``ProcessManager._debug``)

The result summary in ``<name>.json.done`` is the JAX worker's:
``canvas_shape``, ``n_tiles``, ``uca_rounds``.

Departures, forced by CUDA:

- ``--device`` (default ``cuda``) takes the place of ``JAX_PLATFORMS``.
  Without a GPU the worker raises before it claims a job unless
  ``--device cpu`` is given; it never moves to the CPU by itself.
- After each job the worker synchronises the card (an asynchronous fault
  then fails the job that caused it, not the next one) and empties
  PyTorch's cache of device blocks, so a long-lived worker keeps no
  region's blocks from the next job or from another worker on the card.
- An error raised by CUDA itself (``torch.AcceleratorError``, or a
  ``RuntimeError`` of the CUDA runtime, such as a kernel's failed launch)
  may leave the process's CUDA context unusable: the worker marks the job
  failed and exits with :data:`EXIT_CUDA_FAULT`, taking no further job; a
  fresh process (the VM's restart) gets a fresh context.  The job is never
  retried on the CPU.  Any other exception, an out-of-memory error of
  PyTorch's allocator included, fails the job and the worker goes on, as
  the JAX worker does.

Start-up: the worker prints one line with the seconds of ``import torch``,
of creating the CUDA context, of importing the pipeline and of loading the
built kernel library, which a short job pays in full; and one line per job
with its seconds and its kernel launches.

Run: ``python -m pydem_tpu_torch.deploy.worker --queue DIR [--drain]
[--device cuda:1]``; ``python -m pydem_tpu_torch.deploy.submit
--local-workers N`` fans N of these out as processes.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
import traceback

from . import jobqueue as q

# exit status after a CUDA fault: a temporary failure, to be retried by a
# fresh process (EX_TEMPFAIL)
EXIT_CUDA_FAULT = 75

# texts of the RuntimeErrors that the CUDA runtime or driver raise through
# PyTorch, and of the port's own failed kernel launches (ops/uca_block.py)
_CUDA_FAULT_TEXT = ("CUDA error", "CUDA driver error", "cudaError",
                    "CUBLAS_STATUS", "CUDNN_STATUS")


def is_cuda_fault(exc):
    """Whether ``exc`` (or an exception it was raised from) came from CUDA
    itself and may have left the context unusable.  An out-of-memory error
    of PyTorch's allocator does not: the context stays usable."""
    import torch

    accel = getattr(torch, "AcceleratorError", None)
    oom = getattr(torch, "OutOfMemoryError", torch.cuda.OutOfMemoryError)
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if accel is not None and isinstance(exc, accel):
            return True
        if isinstance(exc, RuntimeError) and not isinstance(exc, oom) and \
                any(t in str(exc) for t in _CUDA_FAULT_TEXT):
            return True
        exc = exc.__cause__ or exc.__context__
    return False


def start(device):
    """Import torch, make ``device``'s CUDA context current, import the
    pipeline and load the built kernel library.  Returns the device and the
    seconds of each step."""
    t0 = time.perf_counter()
    import torch

    secs = {"torch_import_s": time.perf_counter() - t0}
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("worker --device %s: torch.cuda is not "
                               "available (--device cpu runs on the CPU)"
                               % device)
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        t0 = time.perf_counter()
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
        secs["cuda_context_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    from .. import manager  # noqa: F401  (the pipeline's modules)

    secs["package_import_s"] = time.perf_counter() - t0
    if dev.type == "cuda":
        from ..ops import _build

        t0 = time.perf_counter()
        _build.load("uca_block")
        secs["library_load_s"] = time.perf_counter() - t0
    secs["total_s"] = sum(secs.values())
    return dev, secs


def run_job(name, spec, device):
    """One job through ``ProcessManager(device=...)``: process, export.
    Returns the JAX worker's result summary."""
    from ..manager import ProcessManager

    kw = dict(in_path=spec["in_path"],
              out_path=spec.get("out_path"),
              dem_proc_kwargs=spec.get("dem_proc_kwargs"),
              resume=True,
              out_of_core=bool(spec.get("out_of_core", False)),
              device=device)
    if spec.get("superblock"):
        kw["superblock"] = int(spec["superblock"])
    if spec.get("_debug"):
        kw["_debug"] = True
    pm = ProcessManager(**kw)
    pm.process_twi()
    if spec.get("export"):
        pm.save_non_overlap_data_geotiff(spec["export"])
    return {"canvas_shape": list(pm.grid_shape),
            "n_tiles": pm.n_inputs,
            "uca_rounds": int(getattr(pm._dp, "uca_sweeps", -1))
            if pm._dp is not None else -1}


def _synchronize(device):
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def _release(device):
    """Synchronise and hand the job's cached device blocks back."""
    _synchronize(device)
    if device.type == "cuda":
        import torch

        torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser(description="pydem_tpu_torch cloud-burst "
                                             "worker")
    ap.add_argument("--queue", required=True,
                    help="shared queue directory (durable storage)")
    ap.add_argument("--lease", type=int, default=600,
                    help="claim lease seconds before another worker "
                         "may steal a stalled job")
    ap.add_argument("--poll", type=float, default=10.0,
                    help="idle poll interval")
    ap.add_argument("--drain", action="store_true",
                    help="exit when no work is claimable (default: keep "
                         "polling — VM mode)")
    ap.add_argument("--max-jobs", type=int, default=0,
                    help="exit after N jobs (0 = unlimited)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the jobs (default cuda; the CPU "
                         "only when asked for with --device cpu)")
    args = ap.parse_args(argv)

    device, secs = start(args.device)
    from ..ops.uca_block import launch_counts

    me = q.worker_id()
    print("[worker %s] start-up on %s: %s" % (me, device, json.dumps(secs)),
          flush=True)
    done = 0
    while True:
        got = q.claim_next(args.queue, lease_s=args.lease)
        if got is None:
            if args.drain:
                return 0
            time.sleep(args.poll)
            continue
        name, spec, claim = got
        stop = threading.Event()

        def beat():  # touches the claim file only
            while not stop.wait(min(args.lease / 3.0, 30.0)):
                q.heartbeat(claim)

        t = threading.Thread(target=beat, daemon=True)
        t.start()
        print("[worker %s] job %s: %s" % (me, name, json.dumps(spec)),
              flush=True)
        t0 = time.perf_counter()
        before = launch_counts()
        try:
            result = run_job(name, spec, device)
            _synchronize(device)  # an asynchronous fault fails this job
        except Exception as exc:
            stop.set()
            q.finish(claim, error=traceback.format_exc())
            if is_cuda_fault(exc):
                print("[worker %s] job %s FAILED on a CUDA fault; exiting: "
                      "%r" % (me, name, exc), flush=True)
                return EXIT_CUDA_FAULT
            print("[worker %s] job %s FAILED" % (me, name), flush=True)
        else:
            stop.set()
            q.finish(claim, result=result)
            after = launch_counts()
            print("[worker %s] job %s done in %.3f s, kernel launches %s: %s"
                  % (me, name, time.perf_counter() - t0,
                     json.dumps({k: after[k] - before[k] for k in after}),
                     json.dumps(result)), flush=True)
        try:
            _release(device)
        except Exception as exc:
            if not is_cuda_fault(exc):
                raise
            print("[worker %s] CUDA fault after job %s; exiting: %r"
                  % (me, name, exc), flush=True)
            return EXIT_CUDA_FAULT
        done += 1
        if args.max_jobs and done >= args.max_jobs:
            return 0


if __name__ == "__main__":
    sys.exit(main())

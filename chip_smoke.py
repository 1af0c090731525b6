#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py              # phases 1-11 and 13-15, one card
    python3 chip_smoke.py --multicard  # phases 1, 2 and 12, four cards

Phases, each reported on its own lines:

1. device: fail unless CUDA is available; print the card's name and power
   limit as ``nvidia-smi`` reports them;
2. build: compile the UCA block kernels K1 and K2 (``nvcc``) and the native
   pit carve (``g++``) from the checkout, at the same time; print the
   kernels' register, spill and shared-memory lines, and for K1's dataflow
   kernel (both forms) and K2 at every block size a line of its
   registers, spills, stack, static and dynamic shared memory a CTA, the
   CTAs of the cluster that relaxes one block (4 at B = 128, 16 at 256)
   and the CTAs or clusters the card holds at once; no kernel may spill
   or keep a stack frame, and a CTA stays under 48 KB of shared memory;
3. kernels vs plain versions on the card, at every block size the kernels
   are built for (the dataflow kernel and K2 at 8, 16, 32, 64, 128 and
   256) on 512², at 128 and 256 on 1024² (where B = 256 has the 3x3 grid a
   subset round takes; there also each cluster kernel's round from the
   base 50 times, bit for bit the first) and at 64, 128 and 256 on the
   main path's 2048², each on the cone and the hard terrain (float32),
   from the terrain step's own receiver planes: K1 in the TPU's
   Gauss-Seidel order in every form (canvas, ring, interior, frame; the
   ring forms on an (n+2)² window whose ring is real; the subsets where
   the grid is 3x3 or more) at each orientation 0-3, a round from the base
   and one on the frontier of its flags, through the dataflow launch
   (``gs_round_oriented``, one launch a round) against the plain round (at
   2048²: orientations 0 and 2 at B = 64, 1 at 128, 3 at 256, the
   frontier round after orientation 0 at 64, 1 at 128, 3 at 256); two K2
   rounds; and the full K1 solve in the TPU's order; they must agree bit
   for bit, flags included, with equal round counts (the solve launches at
   most 3 rounds more than it counts: its flags are read once per 4
   rounds);
4. main path, the terrain step: ``terrain_step(uca_solver="blocked")`` on
   the 2048² cone and hard terrain at its default B = 256 (a cluster of 16
   CTAs a block); the dataflow launch's counter must rise by the rounds,
   all at B = 256, the rounds printed beside those of the same planes at
   B = 64; the facet
   kernel's call counter must rise by one a ``terrain_step`` (each main
   path's run logs its facet calls and launches); the result must match
   ``uca_solver="jacobi"`` (NaN pattern, and the JAX package's own bench
   gate tolerances), repeat bit for bit, and agree with the float64 CPU
   run on a small cone;
5. main path, the hard-terrain chain: ``DEMProcessor(...,
   conditioning_backend="device", pit_backend="device",
   uca_solver="blocked", device="cuda").calc_twi()`` on the 2048² hard
   terrain; the K1 launch counter must rise; uca must match
   ``uca_solver="jacobi"`` within the bench gate with an equal NaN pattern,
   and a second run must repeat it bit for bit;
6. K2's path: on the chain's own receiver planes, base and pit links, two
   K2 rounds at every block size, then ``accumulate_blocked`` and
   ``accumulate_blocked_pits`` with the K2 launch counter read around them;
   each, and K1's ``accumulate_blocked_pits_gs`` (the TPU's order), equal
   to its plain version bit for bit with equal round counts; K2's pit
   solve reaches K1's fixed point within the gate;
7. float64 on the card: the chain's functions (``fill_flats_device``,
   ``drain_pit_paths``, ``pit_links_device_packed``, ``_uca_chain_program``
   with jacobi) at 256² on CUDA against the same calls on the CPU: equal
   flats, NaN pattern and link sets, values equal to relative 1e-9, and the
   ``edge_done`` flood (``_edge_flood_program``) an equal mask;
8. times with CUDA events, median of 3 after a warm-up, per-rep times too
   (the terrain step's own figures are the benchmark's, ``hydrobench/``):
   the hard chain at 2048² through ``tools/hard_breakdown.py`` (5 reps,
   each the chain cut into stages with a synchronisation at each, then
   uncut), one K2 round (B = 256, 128, 64, 32, 16 and 8) beside its plain
   round at 2048²; K1 in the TPU's order at 2048², B = 64, 128 and 256
   (B = 16's rows were cut for the time limit), the dataflow launch: a
   round from the base at each orientation (beside its plain round), a
   skipped round, a partial round (round 12 of the hard chain's pit
   solve), each with its bound counting the blocks it visits; the
   critical path (the round timed with a sleep queued on the card first,
   so that the card runs its launches back to back and no gap left by the
   host counts); the cone solve and the hard chain's pit solve (bound:
   their rounds at a full round's); a round from the base at the mesh's
   B = 32 and 8 beside its plain round; the time of one sweep under a CTA
   barrier (B = 64) and in a cluster (128, 256), with the sweep probe: the
   cluster visit the kernels run (every sweep's edge rows sent as
   asynchronous stores counted on the neighbours' mbarriers, no cluster
   barrier) and the first cluster visit (a cluster barrier a sweep) with
   its stores cut or its barriers after sweeps 1-3 of a group a CTA
   barrier (``uca_block.PROBE_VISITS``; timed only, the cut variants'
   values are wrong by design); and the K2
   and jacobi pit solves.  Each kernel's bound is computed beside
   its time: the bytes of the timed round (every input once, every output
   once) over the card's memory rate, or, if larger, one multiply-add per
   nonzero weight over its float32 rate;
9. main path, the manager: the 2048² hard terrain written as a 2×2 grid of
   overlapping float32 GeoTIFF tiles (overlap 32 rows, 16 columns, lat/lon
   transforms) into a temporary directory, then
   ``ProcessManager(in_path, dem_proc_kwargs=dict(conditioning_backend=
   "device", pit_backend="device", uca_solver="blocked")).process_twi()``
   and ``save_non_overlap_data_geotiff()`` on the default device.  Checked:
   the grid is (2048, 2048) and the mosaic is the unsplit array; the K1
   launch counter rose; the store holds every array with ``success`` all
   True; ``uca`` and ``twi`` equal those of one ``DEMProcessor`` on the
   unsplit array within the hard gate with an equal NaN pattern; each
   exported GeoTIFF reads back to the store's array (float32, NaN as
   -9999) with its overview IFDs (factors 3, 9, 27) and the mosaic's
   transform; ``edge_done`` is the complement of ``reachability`` of
   ``edge_todo`` through the solve's links with no-data pixels done; a
   ``resume=True`` run skips every stage and returns a bitwise equal twi;
   ``python -m pydem_tpu_torch.cli process <dir>`` as a subprocess (the
   default, host, backends on the same 2048² tiles) exits 0 and writes the
   same five files; the default (host) backends at 256² on the card against
   the CPU in float64: on a noisy cone with a no-data notch inside the JAX
   package's float32 envelope (``tests/test_parity_f32.py``), on the hard
   terrain (which float32 takes outside that envelope on any device) an
   equal elevation and NaN pattern, the differences printed.  Timed: the
   manager's stage seconds, tile reading + mosaic, uploads, store writes,
   the GeoTIFF export and the total, median of 3 after the checked run;
10. main path, out of core (``pydem_tpu_torch/outofcore.py``):
    a. K1's ring form in the TPU's order on a 2048² window of a mid-solve
       state of the 4096² cone's planes, in the middle and at the canvas
       corner (cut as the engine cuts it: beyond the canvas the state's NaN
       ring is sanitised to 0): the dataflow launch == plain bit for bit at
       two orientations, the ring untouched; one ring round from the base
       timed beside its plain round, its bound and the 2048² canvas round;
    b. the 8192² float32 cone through ``OutOfCoreEngine(superblock=2048,
       fill_flats=False, drain_pits_path=False).run()`` twice, the store
       in a temporary directory (4096² with S = 1024 if it has too little
       room): with the device budget forced to 0 every stage streams
       windows through the store and every visit runs ring rounds in the
       TPU's order from the outer round's orientation; with the card's own
       budget the stages after conditioning
       run as one device-resident pass.  ``uca``, ``twi``, ``slope``,
       ``aspect`` and ``flats`` of the two must be bitwise equal (NaN
       patterns with them), and ``uca`` must match ``terrain_step`` on
       the whole canvas.  Printed: stage seconds, outer rounds, visits
       made and skipped, K1 launches, bytes and seconds of the store's
       window reads and writes, peak device memory (also of the fused
       pass at 2048² and 4096², in planes of the canvas: the factor of
       ``_fits_device_resident``), and the share of the streamed ``uca``
       stage's wall time in which the kernel ran (CUDA events around
       every launch);
    c. the 2048² hard terrain of phase 9 as the same tiles through
       ``ProcessManager(in_path, out_of_core=True, superblock=512)`` with
       default options (host conditioning per margin window, once) and
       ``save_non_overlap_data_geotiff()``: the store holds every array,
       the files read back to the store, a ``resume=True`` rerun
       recomputes nothing; then the ``uca`` stage again on the same store
       with the budget forced to 0: streamed against device-resident
       ``uca`` inside the hard gate with an equal NaN pattern (pit links
       fold in float64 on the host when streaming, in float32 on the
       card), the link count and the largest difference printed;
    d. the engine on the card (float32) against the engine on the CPU
       (float64) at 256², S = 128: the noisy cone inside the float32
       envelope and its ``uca`` within relative p99 1e-3 of the in-core
       float32 ``DEMProcessor``; the hard terrain printed.
11. main path, the mesh (``pydem_tpu_torch/parallel``), shards on this one
    card:
    a. K1's subset rounds in the TPU's order on 4096² ring windows of a
       mid-solve state of the 8192² cone, the shard shape of b (the
       centred window and b's top-left shard): the interior round, then
       the frame on its output (the split round's compute), the dataflow
       launch == plain bit for bit, the ring untouched; the interior, frame
       and full ring rounds timed beside their byte bounds on the centred
       window;
    b. ``run_sharded(uca_solver="blocked")`` on the 8192² float32 cone over
       a 2×2 mesh of four shards on the card: the split round (interior on
       each shard's stream while the rings are copied, then the frame, in
       place, in the TPU's order); its rounds printed, ``mag``,
       ``direction`` and ``flats`` bitwise and ``uca`` and ``twi`` within
       the cone gate of one device's ``terrain_step(uca_solver="blocked")``;
       wall time, dataflow launches, host reads, peak device memory; one
       device's ``accumulate_blocked_gs`` on the same planes at B = 256 and
       64 (times, rounds); the solve alone with the split and the serial
       round forced (times, rounds; within the gate of each other); the
       one-card overlap of ``measure_halo_overlap``; on the 1024² cone's
       planes over 2×2, the split and the serial solve through the kernel
       against the same mesh through the plain rounds, bit for bit with
       equal rounds; the 2048² cone over 1×2 and 2×4 meshes within the
       gate of ``terrain_step``; at the shard block sizes the JAX mesh
       takes below 64: the 1344² cone over a 2×2 mesh (672² shards, B = 32,
       every dataflow launch at 32) within the gate of ``terrain_step``,
       and the 192² (B = 32) and 80² (B = 8) cones' sharded solves through
       the kernel against the plain rounds, split and serial;
    c. the hard chain's planes and pit links (phase 6) through
       ``sharded_uca(pit_links=...)`` on a 2×2 mesh (split), and the serial
       round forced, within the hard gate of ``accumulate_blocked_pits_gs``
       on one device (rounds printed); then the 512² hard chain's solve on
       a 2×2 mesh, split and serial, through the kernel against the plain
       rounds, bit for bit with equal rounds;
    d. ``ProcessManager(mesh=2×2)`` on the 2048² cone as four tiles,
       ``process_twi()`` and the GeoTIFF export (files read back), against
       the in-memory manager on the same tiles (equal NaN patterns, values
       within the cone's gate), stage seconds printed; then
       ``dryrun_multichip(4)``.
12. ``--multicard`` only, the mesh over four cards, one shard a card
    (``cuda:0..3``, a 2×2 mesh; it fails with fewer than four visible
    cards).  First the cards' index, name and power limit, ``nvidia-smi
    topo -m`` and the ``can_device_access_peer`` matrix; then, on the
    float32 cone:
    a. on every card, one round in the TPU's order and a K2 round (2048²)
       against their plain versions bit for bit; K1's ring and subset
       rounds in the TPU's order at every shard shape that b-f run (8192²,
       4096×16384, 12288², 4096², 1024² windows of a mid-solve state of
       the 16384² cone): the dataflow launch == the plain round up to
       8192² (on the first card; on the others up to 2048²), elsewhere two
       dataflow launches bit for bit; timed at b's shard and c's band; and
       the ring round at g's 24576² shard (a mid-solve state of g's canvas,
       tiled from one ringed cone's), two launches bit for bit, timed;
    b. ``run_sharded(uca_solver="blocked")`` on the 16384² cone over the
       four cards (the serial round), the cone built shard by shard on
       each card (a ``ShardedCanvas``, as a user of four cards hands it
       over): every output shard on its card; against one card's
       ``terrain_step(blocked)``, in turns: ``mag``, ``direction`` and
       ``flats`` bitwise, ``uca`` and ``twi`` within the cone gate, the
       rounds of both printed; both wall times, median of 3 with every
       rep; each card's peak memory, ``cuda:0``'s within 10% of the
       others'; the solve alone with the split and the serial round forced
       over the four cards, timed, each bitwise equal to the same round
       over four shards on ``cuda:0`` with equal rounds; the four-card
       exchange / relax / full round and overlap fraction of
       ``measure_halo_overlap`` (host clock, every card synchronised);
       then ``run_sharded`` over a (4, 1) mesh of the four cards in this
       process, hashed (sha256 of NaN masks and values in 1024-row
       chunks), c's reference;
    c. four processes (spawned), one NCCL rank a card,
       ``multihost.run_global(blocked)`` on the same cone in (4, 1) row
       bands, each output left on its rank as its band: each rank hashes
       its band after the timing, then all join one gather of ``uca``;
       bitwise equal to b's (4, 1) mesh in one process, rounds equal, wall
       and peak by rank (each under 8.5 GB);
    d. the 2048² hard terrain's planes and pit links through ``sharded_uca``
       over the four cards (the serial round) bitwise equal to the same
       round over four shards on one card, rounds equal, and within the
       hard gate of one card's ``accumulate_blocked_pits_gs``;
    e. ``OutOfCoreEngine(superblock=2048)`` over the four cards against the
       same engine over four shards on ``cuda:0`` held to the serial round,
       fused both, bitwise, at 8192²; then at 24576², where one card's budget refuses the fused pass
       and the four cards' admit it (``outofcore.fits_device_resident``):
       the fused pass, each card's peak under its budget, stage seconds and
       rounds, ``uca`` and ``twi`` within the cone gate of ``run_sharded``
       over the same cards, shard by shard (a ~22 GB store in a temporary
       directory);
    f. ``ProcessManager(mesh=the four cards)`` as 11d, and
       ``dryrun_multichip(4)`` with one shard a card;
    g. a canvas that no card could assemble: 3×3 copies of b's cone, each
       with its outer 1-px ring NaN (no flow crosses between copies), a
       49152² float32 canvas over 2×2 (four 24576² shards, which the copies
       straddle), built shard by shard on each card;
       ``run_sharded(blocked)`` on it, every copy's ``mag``, ``direction``
       and ``flats`` bitwise equal (NaN equal) and ``uca`` and ``twi``
       within the cone gate of one card's ``terrain_step(blocked)`` on one
       ringed copy, compared a copy at a time; wall time
       (median of 3 where the phase's budget allows), the rounds of both,
       each card's peak.  It runs with the allocator's expandable segments (set
       just before it; b-f run under the default allocator) and fails on an
       out-of-memory error.
    Then the kernel JSON line with every kernel's launches in the runs of
    b-g, by card, and the last line with ``"count"`` the visible cards.
13. the deployment periphery (``pydem_tpu_torch/deploy``, ``examples``,
    ``tools``), after phase 11, on the card:
    a. two regions, each a 2×2 grid of ~1024² GeoTIFF tiles (2048²
       mosaics: phase 9's hard terrain and the cone), through ``python -m
       pydem_tpu_torch.deploy.submit --local-workers 2 --device cuda
       --export-root`` with the device backends: both jobs done, none
       failed, each job's dataflow launches (its worker's counters) above
       0; each
       region's store ``uca`` and ``twi`` and its five exported GeoTIFFs
       bitwise equal to an in-process ``ProcessManager`` run of the same
       tiles on the card.  Printed: the wall time, each job's seconds and
       px/s, and each worker's start-up seconds (``import torch``, the CUDA
       context, the pipeline's imports, loading the built library);
    b. preemption: a job claimed here runs its ``elevation`` stage in this
       process; its lease is expired, a worker steals and finishes it; its
       store and GeoTIFFs bitwise equal to a's job of the same region;
    c. ``golden_check --device cuda`` passes (the float32 envelope of
       ``tests/test_parity_f32.py`` against ``deploy/goldens``); its
       figures printed;
    d. both examples on the card; ``hard_breakdown``'s command at 2048²,
       its stage sum within 20% of its uncut chain (the median of the
       ratios, rep by rep; phase 8's figures printed beside them);
       ``mesh_scaling`` at 4096², each shape's rounds printed beside one
       device's ``terrain_step``.
    K1's launches in the in-process runs of a and b join the kernel line.
14. the facet sweep kernel (``ops/csrc/facets.cu``, built in phase 2 with
    its register, spill and shared-memory lines; neither kernel may spill):
    on a 6000² float32 noisy cone with geographic row spacings, bit for bit
    the eager sweep (``_slopes_directions_eager``), then both timed, median
    of 5 after a warm-up, beside the byte bound (elevation read once,
    ``mag`` and ``direction`` written once: 12 B a pixel over the card's
    memory rate).
15. the union-find flood kernel (``ops/csrc/flood.cu``, built in phase 2
    with its register, spill and shared-memory lines; no kernel may
    spill): on the flat masks (``mag == -1``) of both benchmark cells'
    surfaces at 6000² (``hydrobench/traffic``: the coast's sea is one
    18 Mpx flat), ``label_flood`` through the kernel, one call and three
    launches as the C entry reports them, bit for bit the eager loop
    (``_label_flood_eager``), labels and ``rep``; then both timed, median
    of 5 after a warm-up, beside the byte bound (the mask read once, the
    labels written once: 5 B a pixel).  Each main path's run of phases 4,
    5 and 9-11 also logs its flood calls and launches (three a call).

Then a JSON line with the kernel table (K1 in the TPU's order, the
dataflow launch, at the main paths' B = 256, at 128 and at 64, with its
figures in every form and its main-path launches by block size; K2 at
256 and 64, each with its launches on the main paths; the
facet sweep with its launches on the main paths, as its C entry counts
them, and phase 14's largest difference from the eager sweep; the flood
with its launches on the main paths and phase 15's times),
and as the last line
``{"ok": true, "device": {...}}``.  Any failure ends the run with a non-zero
exit and no result line.  The port imports neither JAX nor the JAX package.
"""
import collections
import gc
import hashlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from pydem_tpu_torch import default_dtype, fixtures, native, outofcore
from pydem_tpu_torch.api import (DEMProcessor, _edge_flood_program,
                                 _pre_program, _uca_chain_program)
from pydem_tpu_torch.core.conditioning import drain_pit_paths
from pydem_tpu_torch.core.flats_device import fill_flats_device
from pydem_tpu_torch.core.receivers import receiver_weights
from pydem_tpu_torch.core.slope_direction import (_label_flood_eager,
                                                   _slopes_directions_eager,
                                                   label_flood)
from pydem_tpu_torch.core.stencil import dilate
from pydem_tpu_torch.core.uca import (PitLinks, accumulate, base_area,
                                      reachability)
from pydem_tpu_torch.deploy import golden_check, jobqueue
from pydem_tpu_torch.deploy.submit import job_name
from pydem_tpu_torch.examples import process_array, process_manager_directory
from pydem_tpu_torch.geometry import mk_transform
from pydem_tpu_torch.io import read_geotiff, write_geotiff
from pydem_tpu_torch.io.store import ArrayStore
from pydem_tpu_torch.manager import ProcessManager
from pydem_tpu_torch.ops import _build, uca_block
from pydem_tpu_torch.ops.facets import facet_sweep
from pydem_tpu_torch.ops.flood import flood_labels
from pydem_tpu_torch.ops.pit_growth import pit_links_device_packed
from pydem_tpu_torch.outofcore import OutOfCoreEngine
from pydem_tpu_torch.ops.uca_block import (KERNEL_BLOCKS,
                                           accumulate_blocked,
                                           accumulate_blocked_gs,
                                           accumulate_blocked_pits,
                                           accumulate_blocked_pits_gs,
                                           block_round, block_round_plain,
                                           compact_from_dense,
                                           gs_round_oriented,
                                           gs_round_oriented_plain,
                                           kernel_cluster_size,
                                           kernel_smem_bytes, launch_count,
                                           resident_units, visit_sequence)
from pydem_tpu_torch.ops.uca_block import _gs_solve as gs_solve
from pydem_tpu_torch.parallel import sharded
from pydem_tpu_torch.parallel.dryrun import dryrun_multichip
from pydem_tpu_torch.parallel.mesh import (ShardedCanvas, make_mesh, pieces,
                                           shard_dims)
from pydem_tpu_torch.parallel.mesh import split as mesh_split
from pydem_tpu_torch.parallel.sharded import (_block_size,
                                              measure_halo_overlap,
                                              run_sharded, sharded_uca,
                                              terrain_pre, terrain_step)
from pydem_tpu_torch.profiling import StageTimer, counters
from pydem_tpu_torch.tools import hard_breakdown, mesh_scaling
from pydem_tpu_torch.tools.hard_breakdown import make_hard_terrain, run_chain

ROOT = os.path.dirname(os.path.abspath(__file__))
N_MAIN = 2048   # the bench headline canvas
# hard_breakdown's reps (single chain runs spread widely on a shared host),
# and how far a stage sum may be from its uncut chain, rep by rep
BREAKDOWN_REPS, BREAKDOWN_TOL = 5, 0.2
N_CHECK = 512   # a second kernel-vs-plain canvas, few blocks per side
N_OOC, S_OOC = 8192, 2048  # the out-of-core canvas and its super-block
# Kernel vs plain: both sum base + w_0*x_0 + ... + w_7*x_7 in the same order
# with separate float32 multiply and add roundings (the kernel is built with
# -fmad=false), so they must agree exactly.
KERNEL_TOL = 0.0
# blocked vs jacobi reach the same fixed point but sum in another
# association; these are the JAX package's bench gate tolerances.
GATE_TOL = {"cone": dict(rtol=1e-5, atol=1e-3),
            "hard": dict(rtol=1e-4, atol=1e-2)}
# float64 on the card against float64 on the CPU: the same operations, but
# sums over windows reduce in another order on the card
F64_RTOL = 1e-9
CHAIN = dict(conditioning_backend="device", pit_backend="device")
# an H100 SXM's published peaks (NVIDIA's data sheet): HBM3 bytes/s, and
# float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def make_cone(n, dtype="float32"):
    x, y = np.mgrid[-1:1:complex(0, n), -1:1:complex(0, n)]
    elev = 1 - np.sqrt(x**2 + y**2) / np.sqrt(2.0)
    return (elev - elev.min() + 0.05).astype(dtype)


def make_noisy_cone(n, noise=0.003, seed=3):
    """A cone with unquantized noise and a no-data notch, float32 values:
    terrain that float32 keeps inside the JAX package's parity envelope,
    with a few pits left for the host pit search after conditioning."""
    rng = np.random.RandomState(seed)
    x, y = np.mgrid[-1:1:complex(0, n), -1:1:complex(0, n)]
    elev = 1 - np.sqrt(x**2 + y**2) / np.sqrt(2.0) + rng.randn(n, n) * noise
    elev[(x > 0.8) & (np.abs(y) < 0.1)] = np.nan
    return (elev - np.nanmin(elev) + 0.05).astype("float32")


def write_tiles(elev, path, nx_grid=2, ny_grid=2, nx_overlap=16,
                ny_overlap=32, lat=(46, 45), lon=(-73, -72)):
    """``elev`` as a grid of overlapping GeoTIFF tiles with lat/lon
    transforms in ``path``: the tile edges and transforms of the package's
    ``fixtures.mk_test_multifile``, for an array of one's own."""
    os.makedirs(path)

    def chunk_edges(nn, chunk_size, chunk_overlap):
        chunk_size = int(chunk_size)
        left = np.arange(0, nn - chunk_overlap, chunk_size)
        left[1:] -= chunk_overlap // 2
        right = np.arange(0, nn - chunk_overlap, chunk_size)
        right[:-1] = right[1:] + int(np.ceil(chunk_overlap / 2))
        right[-1] = nn
        return left, np.minimum(right, nn)

    ni, nj = elev.shape
    top_edge, bottom_edge = chunk_edges(ni, np.ceil(ni / ny_grid), ny_overlap)
    left_edge, right_edge = chunk_edges(nj, np.ceil(nj / nx_grid), nx_overlap)
    lats = np.linspace(lat[0], lat[1], ni)
    lons = np.linspace(lon[0], lon[1], nj)
    count = 0
    for te, be in zip(top_edge, bottom_edge):
        for le, re_ in zip(left_edge, right_edge):
            count += 1
            block = elev[te:be, le:re_]
            ph = -abs(lats[te] - lats[be - 1]) / (block.shape[0] - 1.0)
            pw = abs(lons[le] - lons[re_ - 1]) / (block.shape[1] - 1.0)
            transform = mk_transform(max(lats[te], lats[be - 1]),
                                     min(lons[le], lons[re_ - 1]), ph, pw,
                                     lat_lon_centered=True)
            write_geotiff(os.path.join(path, "chunk_%03d_elev.tif" % count),
                          block, transform, nodata=-9999)
    return count


def log(phase, msg):
    print("[%s] %s" % (phase, msg), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


# the kernel wrappers by the name of the kernel each launches
WRAPPERS = (("uca_gs_round_dataflow", gs_round_oriented),
            ("uca_block_round", block_round))


def reset_counts():
    """Every kernel wrapper's launch counts to 0 (by device and, where the
    wrapper counts so, by block size); the facet kernel's counters from
    here."""
    for _name, fn in WRAPPERS:
        fn.launches_on.clear()
        getattr(fn, "launches_by_block", {}).clear()
    FACET_AT[:] = [counters["facet_kernel"], counters["facet_launches"]]
    FLOOD_AT[:] = [counters["flood_kernel"], counters["flood_launches"]]


# the dataflow launches of the main paths' runs by block size (phases 4, 5
# and 9-11), and K2's of its path (phase 6), for the kernels line
MAIN_BY_BLOCK = collections.Counter()
K2_BY_BLOCK = {}
# the facet kernel's counters at the last reset_counts(), and its calls and
# launches (as the C entry reports them) in the main paths' runs
FACET_AT = [0, 0]
FACET_MAIN = collections.Counter()
# the same for the flood kernel
FLOOD_AT = [0, 0]
FLOOD_MAIN = collections.Counter()


def facet_since_reset():
    """The facet kernel's (calls, launches) since :func:`reset_counts`."""
    return (counters["facet_kernel"] - FACET_AT[0],
            counters["facet_launches"] - FACET_AT[1])


def main_launches(tag):
    """The dataflow launches since :func:`reset_counts` of a main path's
    run: logged by block size and added to ``MAIN_BY_BLOCK``."""
    by = dict(gs_round_oriented.launches_by_block)
    MAIN_BY_BLOCK.update(by)
    calls, launches = facet_since_reset()
    check(launches == 2 * calls, "%s: %d facet kernel launches for %d calls"
          % (tag, launches, calls))
    FACET_MAIN.update(calls=calls, launches=launches)
    f_calls = counters["flood_kernel"] - FLOOD_AT[0]
    f_launches = counters["flood_launches"] - FLOOD_AT[1]
    check(f_launches == 3 * f_calls, "%s: %d flood kernel launches for %d "
          "calls" % (tag, f_launches, f_calls))
    FLOOD_MAIN.update(calls=f_calls, launches=f_launches)
    log("main", "%s: dataflow launches by block size %s; facet sweep %d "
        "calls, %d launches; flood %d calls, %d launches" % (
            tag, by, calls, launches, f_calls, f_launches))
    return launch_count(gs_round_oriented)


def counts_by_card():
    """Every wrapper's launches since :func:`reset_counts`, by card:
    ``{kernel: {"cuda:k": launches}}``."""
    return {name: {str(d): c for d, c in fn.launches_on.items()}
            for name, fn in WRAPPERS}


def cuda_median_ms(fn, reps=3, warmup=1):
    """Median and per-rep milliseconds of ``fn()`` between CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), times


def spacing(n, dtype, device):
    ones = lambda k: torch.ones(k, dtype=dtype, device=device)  # noqa: E731
    return ones(n - 1), ones(n - 1), ones(n), ones(n)


def weights_and_base(elev):
    """The terrain step's receiver planes and base area for ``elev``."""
    _mag, _dir, _flats, W, base = terrain_pre(
        elev, *spacing(elev.shape[0], elev.dtype, elev.device))
    return W, base.contiguous()


def nan_equal_max_err(a, b):
    check(bool(torch.equal(torch.isnan(a), torch.isnan(b))),
          "NaN patterns differ")
    diff = (torch.nan_to_num(a) - torch.nan_to_num(b)).abs()
    return float(diff.max())


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    log("device", "torch %s, CUDA %s, %s x%d" % (
        torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0),
        torch.cuda.device_count()))
    return card


def phase_build():
    """nvcc for the kernels' source and g++ for the carve, started
    together."""
    with ThreadPoolExecutor(4) as pool:
        cuda = pool.submit(_build.build, "uca_block")
        facets = pool.submit(_build.build, "facets")
        flood = pool.submit(_build.build, "flood")
        carve = pool.submit(native.build)
        (path, seconds, build_log), (so, so_seconds) = (cuda.result(),
                                                        carve.result())
        facet_build, flood_build = facets.result(), flood.result()
    log("build", "%s built in %.2f s" % (os.path.relpath(path, ROOT), seconds))
    facet_kernels(*facet_build)
    flood_kernels(*flood_build)
    # ptxas: registers, spills, stack and static shared memory by kernel
    ptxas, name = {}, None
    for line in build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("build", line.strip())
        entry = re.search(r"entry function '\S*?\d(uca_[a-z_]+_kernel)ILi"
                          r"(\d+)(?:ELi(\d))?E", line)
        if entry:
            name = (entry.group(1), int(entry.group(2)),
                    int(entry.group(3) or 0))
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
        if frame:
            log("build", line.strip())
            check(not any(int(g) for g in frame.groups()),
                  "a kernel spills or keeps its arrays in local memory: %s %s"
                  % (name, line.strip()))
            ptxas[name] = dict(zip(("stack", "spill_st", "spill_ld"),
                                   map(int, frame.groups())))
        regs = re.search(r"Used (\d+) registers.*?(?:(\d+) bytes smem)?$",
                         line)
        if regs and name in ptxas:
            ptxas[name].update(registers=int(regs.group(1)),
                               static_smem=int(regs.group(2) or 0))
    # K1 in the TPU's order (both forms) and K2 at every block size
    want = {("uca_gs_dataflow_kernel", B, r) for B in KERNEL_BLOCKS
            for r in (0, 1)}
    want |= {("uca_block_round_kernel", B, 0) for B in KERNEL_BLOCKS}
    # the sweep probe: each cluster visit at 128 and 256
    want |= {("uca_probe_kernel", B, v) for B in (128, 256)
             for v in range(len(uca_block.PROBE_VISITS))}
    check(want <= set(ptxas), "no ptxas lines for %s" % sorted(
        want - set(ptxas)))
    # the kernels use dynamic shared memory, which ptxas does not report:
    # the library says what a CTA launches with; at B = 128 and 256 a block
    # visit is a cluster of CTAs, and the card holds so many of them at once
    dev = torch.device("cuda", 0)
    for B in KERNEL_BLOCKS:
        smem = kernel_smem_bytes(B)
        check(0 < smem < 48 * 1024, "a CTA at B=%d takes %d bytes of "
              "shared memory" % (B, smem))
        for kernel, kind, ring in (("uca_gs_dataflow_kernel", "dataflow", 0),
                                   ("uca_gs_dataflow_kernel", "dataflow", 1),
                                   ("uca_block_round_kernel", "k2", 0)):
            info = ptxas[(kernel, B, ring)]
            log("build", "%s<B=%d%s>: %d registers, %d bytes spilled, %d "
                "bytes stack, %d bytes static + %d bytes dynamic shared "
                "memory a CTA, a cluster of %d CTA(s) a block, %d %s "
                "resident at once" % (
                    kernel, B, ", ring" if ring else "", info["registers"],
                    info["spill_st"], info["stack"], info["static_smem"],
                    smem, kernel_cluster_size(B),
                    resident_units(dev, B, bool(ring), kind),
                    "CTAs" if kernel_cluster_size(B) == 1 else "clusters"))
    for B in (128, 256):
        log("build", "uca_probe_kernel<B=%d>: registers by visit %s" % (
            B, {v: ptxas[("uca_probe_kernel", B, i)]["registers"]
                for i, v in enumerate(uca_block.PROBE_VISITS)}))
    log("build", "%s built in %.2f s (g++)" % (os.path.relpath(so, ROOT),
                                                 so_seconds))


def facet_kernels(path, seconds, build_log):
    """Log the facet kernels' build (:func:`library_kernels`): both
    instantiations of both kernels."""
    def name(line):
        entry = re.search(r"entry function '\S*?(facet_[a-z]+_kernel)I([fd])E",
                          line)
        return entry and "%s<%s>" % (
            entry.group(1), "float" if entry.group(2) == "f" else "double")

    library_kernels(path, seconds, build_log, name, 4)


def flood_kernels(path, seconds, build_log):
    """Log the flood kernels' build (:func:`library_kernels`): the local
    pass, the merge and the compress."""
    def name(line):
        entry = re.search(r"entry function '\S*?(flood_[a-z]+_kernel)", line)
        return entry and entry.group(1)

    library_kernels(path, seconds, build_log, name, 3)


def library_kernels(path, seconds, build_log, name_of, want):
    """Log a library's build: each kernel's registers, spills, stack and
    static shared memory (``name_of`` names the kernel of a ptxas entry
    line, or gives None); none may spill or keep a stack frame, and the
    log must hold ``want`` kernels."""
    log("build", "%s built in %.2f s" % (os.path.relpath(path, ROOT),
                                          seconds))
    seen, name = set(), None
    for line in build_log.splitlines():
        name = name_of(line) or name
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
        if frame and name:
            check(not any(int(g) for g in frame.groups()),
                  "%s spills or keeps a stack frame: %s" % (name,
                                                            line.strip()))
        if "Used" in line and "registers" in line and name:
            seen.add(name)
            log("build", "%s: %s" % (name, line.strip()))
    check(len(seen) == want, "ptxas lines for %d kernels of %s, got %s"
          % (want, os.path.basename(path), sorted(seen)))


def k2_rounds_vs_plain(name, W, base, blocks=KERNEL_BLOCKS):
    """Two K2 rounds at each block size of ``blocks``, kernel beside plain,
    bit for bit.  Returns the largest difference (0.0)."""
    n = base.shape[0]
    W = W.contiguous()
    worst = 0.0
    for B in blocks:
        kw = dict(B=B, inner_max=2 * B + 4)
        x = base
        for r in range(2):
            xk, ck = block_round(x, W, base, **kw)
            xp, cp = block_round_plain(x, W, base, **kw)
            torch.cuda.synchronize()
            err = nan_equal_max_err(xk, xp)
            worst = max(worst, err)
            check(err <= KERNEL_TOL and torch.equal(ck, cp),
                  "K2 %s %d² B=%d round %d: kernel != plain (max err %g, "
                  "flags equal %s)" % (name, n, B, r, err,
                                       torch.equal(ck, cp)))
            x = xk
        log("kernel", "K2 %s %d² B=%d: 2 rounds kernel == plain, %d of %d "
            "blocks changed in round 2" % (name, n, B, int(ck.sum()),
                                           ck.numel()))
    return worst


# K1's forms in the TPU's order: (name, ring, subset)
K1_FORMS = (("canvas", False, "all"), ("ring", True, "all"),
            ("interior", True, "interior"), ("boundary", True, "boundary"))


def form_inputs(elev, ring):
    """K1's inputs for a form on the (n+2)² terrain ``elev``: the ring form
    takes the whole window (its ring the neighbours' base, K and W1 real),
    the canvas form the n² region alone.  Returns ``(x, K, W1, base)``."""
    W, base = weights_and_base(elev)
    K, W1 = compact_from_dense(W)
    region = base[1:-1, 1:-1].contiguous()
    if ring:
        return base.contiguous(), K, W1, region
    cut = lambda a: a[1:-1, 1:-1].contiguous()  # noqa: E731
    return cut(base), cut(K), cut(W1), region


def oriented_vs_plain(tag, args, o, B, ring, subset, prev=None):
    """One K1 round in the TPU's order through the dataflow launch (at
    B = 128 and 256 a cluster a block) and the plain version on the same
    inputs: canvas and flags bit for bit, one launch.  Returns ``(max
    error, dataflow canvas, its flags)``."""
    x, K, W1, base = args
    kw = dict(B=B, inner_max=2 * B + 4, prev=prev, ring=ring, subset=subset)
    before = launch_count(gs_round_oriented)
    xd, cd = gs_round_oriented(x, K, W1, base, o, **kw)
    launches = launch_count(gs_round_oriented) - before
    xp, cp = gs_round_oriented_plain(x, K, W1, base, o, **kw)
    torch.cuda.synchronize()
    err = nan_equal_max_err(xd, xp)
    check(err <= KERNEL_TOL and torch.equal(cd, cp) and launches == 1,
          "%s B=%d orientation %d: dataflow != plain (max err %g, flags "
          "equal %s, launches %d)"
          % (tag, B, o, err, torch.equal(cd, cp), launches))
    return err, xd, cd


def k1_forms_vs_plain(name, elev, n, orientations=None, frontier=None,
                      blocks=KERNEL_BLOCKS):
    """K1 in the TPU's order, every form at every orientation (or those of
    ``orientations[B]``) and block size on the (n+2)² terrain ``elev``: a
    round from the base with every block dirty, then (after the rounds at
    the orientations of ``frontier[B]``, default all) one at the next
    orientation with the frontier of its flags, dataflow == plain bit for
    bit; the input canvas comes back unwritten.  Returns the largest
    difference (0.0)."""
    worst = 0.0
    for form, ring, subset in K1_FORMS:
        args = form_inputs(elev, ring)
        x0 = args[0].clone()
        for B in blocks:
            if subset != "all" and n // B < 3:
                continue  # a subset needs a 3x3 block grid
            changed = []
            for o in (orientations or {}).get(B, range(4)):
                tag = "%s %d² %s" % (name, n, form)
                err, xd, cd = oriented_vs_plain(tag, args, o, B, ring,
                                                subset)
                worst = max(worst, err)
                changed.append(int(cd.sum()))
                if frontier is not None and o not in frontier.get(B, ()):
                    continue
                # the next round's frontier from these flags
                err, _x, c2 = oriented_vs_plain(
                    tag + " (frontier)", (xd,) + args[1:], (o + 1) % 4, B,
                    ring, subset, prev=cd)
                worst = max(worst, err)
                changed.append(int(c2.sum()))
            check(torch.equal(args[0], x0), "a round in the TPU's order "
                  "wrote its input canvas")
            log("kernel", "%s %d² %s B=%d: rounds in the TPU's order from "
                "the base and on their frontier, dataflow%s == plain; "
                "blocks changed %s" % (
                    name, n, form, B, " (cluster)" if B > 64 else "",
                    changed))
    return worst


def make_hard_f32(n):
    return make_hard_terrain(n, "float32")


REPEATS = 50


def repeats_bitwise(device, n=1024, blocks=(128, 256)):
    """Each cluster kernel's round from the base on the n² hard terrain
    (the dataflow launch in the canvas and the ring form, K2)
    ``REPEATS`` times: every canvas and flag plane bit for bit the first,
    and that one the plain round's (a guard against a memory-order race
    between a cluster's bands or between dependent blocks)."""
    elev = torch.from_numpy(make_hard_f32(n + 2)).to(device)
    for B in blocks:
        kw = dict(B=B, inner_max=2 * B + 4)
        for form, ring in (("canvas", False), ("ring", True)):
            x, K, W1, base = form_inputs(elev, ring)
            runs = [(gs_round_oriented, gs_round_oriented_plain,
                     (x, K, W1, base, 1), dict(kw, ring=ring))]
            if not ring:
                W, b = weights_and_base(elev[1:-1, 1:-1].contiguous())
                runs.append((block_round, block_round_plain,
                             (b, W.contiguous(), b), kw))
            for fn, plain, args, kws in runs:
                want, want_chg = plain(*args, **kws)
                same = 0
                for _ in range(REPEATS):
                    got, chg = fn(*args, **kws)
                    same += torch.equal(got, want) and torch.equal(chg,
                                                                   want_chg)
                check(same == REPEATS, "%s %s B=%d: %d of %d repeats equal "
                      "the plain round" % (fn.__name__, form, B, same,
                                           REPEATS))
                log("kernel", "%s (%s) %d² hard B=%d: %d repeats of the round "
                    "from the base == plain bit for bit"
                    % (fn.__name__, form, n, B, REPEATS))


def ring_terrain(kind, n, device):
    """The (n+2)² terrain of ``kind`` whose n² region the ring forms tile
    (its ring the neighbours' pixels)."""
    return torch.from_numpy(kind(n + 2)).to(device)


# where the plain rounds cost the most (2048²: ~1.3 s a round at B = 64),
# phase 3 holds every form from the base at orientations
# 0 and 2 at B = 64, 1 at B = 128 and 3 at B = 256, and the frontier
# round after orientation 0 at B = 64, 1 at 128 and 3 at 256 (at 512² and
# 1024² every form, orientation and frontier round)
K1_FORM_CUTS = {N_MAIN: dict(
    orientations={64: (0, 2), 128: (1,), 256: (3,)},
    frontier={64: (0,), 128: (1,), 256: (3,)})}
# the canvases of phase 3: at 512² B = 256 is a 2x2 grid (no subset round),
# at 1024² a 4x4 one
N_FORMS = 1024


def phase3_blocks(n):
    """The block sizes phase 3 holds on the n² canvas."""
    return {N_CHECK: KERNEL_BLOCKS, N_FORMS: (128, 256)}.get(n, TIMED_BLOCKS)


def phase_kernel_vs_plain(device, n, blocks=KERNEL_BLOCKS):
    """K1 in the TPU's order in every form (:func:`k1_forms_vs_plain`), two
    K2 rounds and the full K1 solve on n² terrains, kernel beside plain,
    bit for bit, at the block sizes ``blocks``.  Returns the largest
    differences (K1, K2)."""
    worst = worst_k2 = 0.0
    for name, kind in (("cone", make_cone), ("hard", make_hard_f32)):
        elev = torch.from_numpy(kind(n)).to(device)
        W, base = weights_and_base(elev)
        worst_k2 = max(worst_k2, k2_rounds_vs_plain(name, W, base, blocks))
        worst = max(worst, k1_forms_vs_plain(
            name, ring_terrain(kind, n, device), n, blocks=blocks,
            **K1_FORM_CUTS.get(n, {})))
        for B in blocks:
            before = launch_count(gs_round_oriented)
            ak, rk = accumulate_blocked_gs(base, W, B=B)
            launches = launch_count(gs_round_oriented) - before
            ap, rp = accumulate_blocked_gs(base, W, B=B,
                                           round_fn=gs_round_oriented_plain)
            err = nan_equal_max_err(ak, ap)
            worst = max(worst, err)
            check(err <= KERNEL_TOL and rk == rp and rk <= launches <= rk + 3,
                  "%s %d² B=%d full solve: kernel != plain (max err %g, "
                  "rounds %d vs %d, %d launches)"
                  % (name, n, B, err, rk, rp, launches))
            log("kernel", "%s %d² B=%d full solve in the TPU's order: the "
                "dataflow launch == plain, %d rounds both, %d launches"
                % (name, n, B, rk, launches))
    return worst, worst_k2


def phase_main_path(device):
    """terrain_step(blocked) at the headline size, gated against jacobi."""
    terrains = {"cone": make_cone(N_MAIN),
                "hard": make_hard_terrain(N_MAIN, "float32")}
    elevs = {k: torch.from_numpy(v).to(device) for k, v in terrains.items()}
    args = spacing(N_MAIN, torch.float32, device)

    reset_counts()
    reads = counters["solve_reads"]
    blocked = {k: terrain_step(e, *args, uca_solver="blocked")
               for k, e in elevs.items()}
    torch.cuda.synchronize()
    launches = main_launches("4 terrain_step")
    check(launches > 0, "the main path launched the UCA kernel no time")
    check(facet_since_reset()[0] == len(blocked),
          "%d facet kernel calls for %d terrain_step calls"
          % (facet_since_reset()[0], len(blocked)))
    B = _block_size(N_MAIN, N_MAIN)
    check(gs_round_oriented.launches_by_block[B] == launches,
          "terrain_step launched the dataflow kernel at other block sizes "
          "than its default %d: %s" % (B, dict(
              gs_round_oriented.launches_by_block)))
    rounds = sum(b["uca_sweeps"] for b in blocked.values())
    check(rounds <= launches <= rounds + 3 * len(blocked),
          "terrain_step: %d launches for %d rounds" % (launches, rounds))
    log("main", "terrain_step(blocked) on the %d² cone and hard terrain: %d "
        "dataflow launches at B=%d (a cluster of %d CTAs a block) for %d "
        "rounds in the TPU's order (%s rounds), %d host reads of the flags"
        % (N_MAIN, launches, B, kernel_cluster_size(B), rounds,
           {k: b["uca_sweeps"] for k, b in blocked.items()},
           counters["solve_reads"] - reads))
    # the rounds the same planes take at the old default, B = 64
    at64 = {k: accumulate_blocked_gs(*weights_and_base(e)[::-1], B=64)[1]
            for k, e in elevs.items()}
    log("main", "terrain_step's solve on the same planes: rounds at B=%d %s, "
        "at B=64 %s" % (B, {k: b["uca_sweeps"] for k, b in blocked.items()},
                        at64))

    for k, e in elevs.items():
        b = blocked[k]
        for key in ("mag", "direction", "flats", "uca", "twi"):
            check(tuple(b[key].shape) == (N_MAIN, N_MAIN),
                  "%s %s has shape %s" % (k, key, tuple(b[key].shape)))
        finite = torch.isfinite(b["uca"])
        check(bool((finite | b["flats"]).all()),
              "%s: non-finite uca outside flats" % k)
        check(bool((b["uca"][finite] > 0).all()), "%s: uca <= 0" % k)
        j = terrain_step(e, *args, uca_solver="jacobi")
        err = nan_equal_max_err(b["uca"], j["uca"])
        ok = torch.allclose(torch.nan_to_num(b["uca"]),
                            torch.nan_to_num(j["uca"]), **GATE_TOL[k])
        check(ok, "%s: blocked vs jacobi uca differ (max %g)" % (k, err))
        again = terrain_step(e, *args, uca_solver="blocked")
        for key in ("mag", "direction", "flats", "uca", "twi"):
            check(torch.equal(torch.nan_to_num(again[key]),
                              torch.nan_to_num(b[key])),
                  "%s: blocked %s not deterministic" % (k, key))
        log("main", "%s %d²: blocked == jacobi within %s (max abs %g, %d "
            "rounds vs %d sweeps), NaN pattern equal, repeat bitwise equal"
            % (k, N_MAIN, GATE_TOL[k], err, b["uca_sweeps"],
               j["uca_sweeps"]))

    # the float64 CPU run is what the CPU tests hold against the JAX package;
    # float32 flips near-tie facets, so hold it to the JAX package's f32
    # parity envelope (tests/test_parity_f32.py) rather than a tolerance
    n = 128
    cone = make_cone(n, "float64")
    ref = terrain_step(torch.from_numpy(cone),
                       *spacing(n, default_dtype("cpu"), "cpu"),
                       uca_solver="jacobi")
    got = terrain_step(torch.from_numpy(cone).float().to(device),
                       *spacing(n, torch.float32, device),
                       uca_solver="blocked")
    check(torch.equal(got["flats"].cpu(), ref["flats"]), "small cone: flats")
    stats = {}
    for key in ("mag", "direction", "uca", "twi"):
        a, b = ref[key], got[key].cpu().double()
        check(torch.equal(torch.isnan(a), torch.isnan(b)),
              "small cone: %s NaN pattern" % key)
        ok = torch.isfinite(a) & torch.isfinite(b)
        rel = (a[ok] - b[ok]).abs() / a[ok].abs().clamp_min(1e-30)
        stats[key] = (float(torch.quantile(rel, 0.99)),
                      float((rel > 1e-3).double().mean()))
    check(stats["mag"][0] < 1e-5 and stats["direction"][0] < 1e-4
          and stats["direction"][1] < 0.02 and stats["uca"][0] < 0.25
          and stats["twi"][0] < 0.06,
          "small cone: card float32 outside the f32 envelope: %s" % stats)
    log("main", "%d² cone: card float32 blocked vs CPU float64 jacobi inside "
        "the f32 envelope, (rel p99, share > 1e-3) = %s" % (n, stats))
    return launches


def chain_state(elev, device):
    """The hard chain's receiver planes, base and pit links at its solve, as
    ``DEMProcessor._calc_uca_device`` builds them."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dp = DEMProcessor(elev=elev.copy(), device=device, **CHAIN)
        dp._slopes_device()
        elev_d = dp._dev("elev")
        W = receiver_weights(dp._dev("section"), dp._dev("proportion"),
                             elev_d).contiguous()
        base = base_area(dp._to_dev(dp.dX2), dp._to_dev(dp.dY2),
                         elev_d.shape, elev_d.dtype).contiguous()
        packed = pit_links_device_packed(dp._dev("flats"), elev_d, dp.dX,
                                         dp.dY)
    check(packed is not None and packed["n_links"] > 0,
          "the conditioned hard terrain has no pit links")
    return W, base, (packed["src"], packed["dst"], packed["wgt"])


def phase_hard_chain(device):
    """DEMProcessor's device chain (blocked, K1 with the pit fold) on the
    2048² hard terrain, gated against jacobi and repeated."""
    elev = make_hard_terrain(N_MAIN)
    reset_counts()
    dp, twi = run_chain(elev, device)
    torch.cuda.synchronize()
    launches = main_launches("5 hard chain")
    B = _block_size(N_MAIN, N_MAIN)
    check(gs_round_oriented.launches_by_block[B] == launches > 0,
          "the hard chain launched the dataflow kernel at other block sizes "
          "than its default %d" % B)
    check(dp.uca_sweeps <= launches <= dp.uca_sweeps + 3,
          "the hard chain launched K1 %d times for %d rounds"
          % (launches, dp.uca_sweeps))
    uca = dp._dev("uca")
    check(tuple(uca.shape) == (N_MAIN, N_MAIN) and twi.shape == uca.shape,
          "hard chain: uca %s, twi %s" % (tuple(uca.shape), twi.shape))
    finite = torch.isfinite(uca)
    check(bool((finite | dp._dev("flats")).all()),
          "hard chain: non-finite uca outside flats")
    check(bool((uca[finite] > 0).all()), "hard chain: uca <= 0")
    log("main", "DEMProcessor(blocked, cuda) hard %d²: %d K1 launches at "
        "B=%d, %d rounds, %d flat px" % (N_MAIN, launches, B, dp.uca_sweeps,
                                         int(dp._dev("flats").sum())))

    dj, _twi = run_chain(elev, device, uca_solver="jacobi")
    err = nan_equal_max_err(uca, dj._dev("uca"))
    check(torch.allclose(torch.nan_to_num(uca),
                         torch.nan_to_num(dj._dev("uca")), **GATE_TOL["hard"]),
          "hard chain: blocked vs jacobi uca differ (max %g)" % err)
    again, twi2 = run_chain(elev, device)
    for key in ("uca", "mag", "flats", "twi"):
        check(torch.equal(torch.nan_to_num(again._dev(key)),
                          torch.nan_to_num(dp._dev(key))),
              "hard chain: blocked %s not deterministic" % key)
    check(np.array_equal(np.nan_to_num(twi2), np.nan_to_num(twi)),
          "hard chain: calc_twi not deterministic")
    log("main", "hard chain %d²: blocked == jacobi within %s (max abs %g, %d "
        "rounds vs %d sweeps), NaN pattern equal, repeat bitwise equal"
        % (N_MAIN, GATE_TOL["hard"], err, dp.uca_sweeps, dj.uca_sweeps))
    return launches


def phase_k2_path(device):
    """K2 on the hard chain's own state: rounds and both solves, kernel
    beside plain; K1's pit solve beside its plain version; K2's and K1's
    pit solves against each other.  Returns (K2 launches, K2 worst error,
    K1 worst error, state)."""
    state = chain_state(make_hard_terrain(N_MAIN), device)
    W, base, links = state
    worst_k2 = k2_rounds_vs_plain("conditioned hard", W, base)

    block_round.launches_on.clear()
    block_round.launches_by_block.clear()
    ak, rk = accumulate_blocked(base, W)
    pk, prk = accumulate_blocked_pits(base, W, *links)
    torch.cuda.synchronize()
    launches = launch_count(block_round)
    K2_BY_BLOCK.update(block_round.launches_by_block)
    check(K2_BY_BLOCK == {256: launches}, "K2's path launched K2 at other "
          "block sizes than the solvers' default 256: %s" % K2_BY_BLOCK)
    check(launches == rk + prk > 0,
          "K2's path launched K2 %d times for %d + %d rounds"
          % (launches, rk, prk))
    log("k2", "K2 path on the chain's planes and %d pit links: %d launches "
        "(accumulate_blocked %d rounds, accumulate_blocked_pits %d rounds)"
        % (len(links[0]), launches, rk, prk))
    ap, rp = accumulate_blocked(base, W, round_fn=block_round_plain)
    pp, prp = accumulate_blocked_pits(base, W, *links,
                                      round_fn=block_round_plain)
    for what, k, pl, r1, r2 in (("accumulate_blocked", ak, ap, rk, rp),
                                ("accumulate_blocked_pits", pk, pp, prk, prp)):
        err = nan_equal_max_err(k, pl)
        worst_k2 = max(worst_k2, err)
        check(err <= KERNEL_TOL and r1 == r2, "%s: kernel != plain (max err "
              "%g, rounds %d vs %d)" % (what, err, r1, r2))
        log("k2", "%s: kernel == plain, %d rounds" % (what, r1))

    gk, grk = accumulate_blocked_pits_gs(base, W, *links)
    _g64, r64 = accumulate_blocked_pits_gs(base, W, *links, B=64)
    log("k2", "the hard chain's pit solve in the TPU's order: %d rounds at "
        "the default B=256, %d at B=64" % (grk, r64))
    gp, grp = accumulate_blocked_pits_gs(base, W, *links,
                                         round_fn=gs_round_oriented_plain)
    worst_k1 = nan_equal_max_err(gk, gp)
    check(worst_k1 <= KERNEL_TOL and grk == grp,
          "accumulate_blocked_pits_gs: kernel != plain (max err %g, rounds "
          "%d vs %d)" % (worst_k1, grk, grp))
    log("k2", "accumulate_blocked_pits_gs (K1 in the TPU's order + fold): "
        "kernel == plain, %d rounds" % grk)

    err = nan_equal_max_err(pk, gk)
    check(torch.allclose(pk, gk, **GATE_TOL["hard"]),
          "K2 and K1 pit solves differ (max %g)" % err)
    log("k2", "K2 and K1 (the TPU's order) pit solves agree within %s (max "
        "abs %g)" % (GATE_TOL["hard"], err))
    return launches, worst_k2, worst_k1, state


def phase_f64_chain(device, n=256):
    """The chain's functions in float64 on the card against the CPU."""
    elev = make_hard_terrain(n)
    one = np.ones(n - 1)
    runs = {}
    for where, dev in (("cpu", torch.device("cpu")), ("card", device)):
        def t(a, dev=dev):
            return torch.as_tensor(a, dtype=torch.float64, device=dev)

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            filled = fill_flats_device(t(elev))
            carved = drain_pit_paths(filled.cpu().numpy(), one, one)
            e = t(carved)
            mag, _direction, flats, section, proportion = _pre_program(
                e, t(one), t(one))
            packed = pit_links_device_packed(flats, e, one, one)
            area, sweeps, _min, todo, flats2, _mag2 = _uca_chain_program(
                e, section, proportion, flats, mag, t(np.ones(n)),
                t(np.ones(n)), packed["src"], packed["dst"], packed["wgt"],
                packed["drained_idx"], packed["drained_mag"], True, True,
                10 ** 6, 4, solver="jacobi")
            flood = _edge_flood_program(e, section, proportion, todo,
                                        packed["src"], packed["dst"],
                                        packed["wgt"])
        order = np.lexsort((packed["dst"].cpu().numpy(),
                            packed["src"].cpu().numpy()))
        runs[where] = dict(
            filled=filled.cpu(), carved=torch.from_numpy(carved),
            area=area.cpu(), flats=flats.cpu(), flats2=flats2.cpu(),
            todo=todo.cpu(), done=~flood.cpu(),
            links=torch.stack([packed[k].cpu()[order]
                               for k in ("src", "dst")]),
            wgt=packed["wgt"].cpu()[order], sweeps=sweeps)
    a, b = runs["cpu"], runs["card"]
    for key in ("flats", "flats2", "links", "todo", "done"):
        check(torch.equal(a[key], b[key]), "float64 card vs CPU: %s differ"
              % key)
    check(bool(a["todo"].any()) and not bool(a["done"].all()),
          "float64 chain: the edge flood had nothing to flood")
    check(a["sweeps"] == b["sweeps"], "float64 card vs CPU: %d vs %d sweeps"
          % (a["sweeps"], b["sweeps"]))
    worst = {}
    for key in ("filled", "carved", "wgt", "area"):
        nan_equal_max_err(a[key], b[key])
        ok = ~torch.isnan(a[key])
        rel = ((a[key][ok] - b[key][ok]).abs()
               / a[key][ok].abs().clamp_min(1e-300))
        worst[key] = float(rel.max())
        check(worst[key] <= F64_RTOL, "float64 card vs CPU: %s rel %g"
              % (key, worst[key]))
    log("f64", "%d² chain in float64, card vs CPU: flats, NaN pattern, %d "
        "links, %d sweeps and the edge_done flood (%d px not done) equal; "
        "max relative differences %s"
        % (n, a["links"].shape[1], a["sweeps"], int((~a["done"]).sum()),
           worst))


def time_chain(device, card):
    """``hard_breakdown`` at N_MAIN² on the card: each rep the hard chain
    cut into stages (a synchronisation at each) and then uncut."""
    hb = hard_breakdown.breakdown(N_MAIN, BREAKDOWN_REPS, str(device))
    for label, st in hb["stages"].items():
        log("time", "hard chain %d² stage %-36s %-6s median %.3f ms, reps %s "
            "ms [%s]" % (N_MAIN, label, st["clock"], st["median"],
                         ["%.3f" % t for t in st["reps"]], card))
    log("time", "hard chain %d²: uncut median %.3f ms (reps %s), %.4g px/s; "
        "stage sum median %.3f ms; sum / uncut rep by rep %s; %d blocked "
        "rounds [%s]" % (
            N_MAIN, hb["chain"]["median"],
            ["%.3f" % t for t in hb["chain"]["reps"]],
            N_MAIN * N_MAIN / (hb["chain"]["median"] / 1e3),
            hb["sum"]["median"], ["%.3f" % r for r in hb["ratio"]["reps"]],
            hb["uca_rounds"], card))
    return hb


def time_round(name, fns, args, card, plain_reps=5):
    """One round of each of ``fns``, median of 5 (the plain one:
    ``plain_reps``) after a warm-up; the outputs must agree bit for bit.
    Returns (ms per fn, max error)."""
    times, outs = {}, {}
    for label, fn in fns:
        def one_round():
            outs[label] = fn(*args[0], **args[1])

        ms, reps = cuda_median_ms(
            one_round, reps=plain_reps if label == "plain" else 5)
        times[label] = ms
        log("time", "%s, %s: median %.3f ms, reps %s ms [%s]"
            % (name, label, ms, ["%.3f" % t for t in reps], card))
    (xk, ck), (xp, cp) = outs["kernel"], outs["plain"]
    err = nan_equal_max_err(xk, xp)
    check(err <= KERNEL_TOL and torch.equal(ck, cp),
          "timed %s: kernel != plain (max err %g, flags equal %s)"
          % (name, err, torch.equal(ck, cp)))
    return times, err


def round_bound(inputs, outputs, W):
    """The least time one round could take on the card, in ms, and what
    bounds it: every input read once and every output written once at the
    HBM rate, or one multiply-add per nonzero weight of ``W`` at the float32
    rate."""
    nbytes = sum(t.numel() * t.element_size() for t in inputs + outputs)
    flops = 2 * int(torch.count_nonzero(W))
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / F32_FLOPS * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def solve_ms(fn, label, card):
    """``fn()`` (a solve returning ``(area, rounds)``) between CUDA events,
    median of 3 after a warm-up.  Returns ``(ms, rounds)``."""
    out = []
    ms, reps = cuda_median_ms(lambda: out.append(fn()))
    log("time", "%s: median %.3f ms, reps %s ms, %d rounds [%s]"
        % (label, ms, ["%.3f" % t for t in reps], out[-1][1], card))
    return ms, out[-1][1]


def hold_card(launches):
    """Queue a sleep on the card long enough for the host to enqueue
    ``launches`` launches meanwhile (~0.1 ms of host time each, at up to
    2 GHz): the card then runs them back to back, and events between them
    read the card's time alone, never a gap left by the host."""
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e9 * (0.02 + 1e-4 * launches)))


def held_ms(fn, launches):
    """``fn()`` between CUDA events, the card held behind the host
    (:func:`hold_card`): the card's time for its ``launches`` launches."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    hold_card(launches)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def partial_round(base, W, links, B, r):
    """The inputs of round ``r`` of the pit solve ``accumulate_blocked_pits_gs``
    (the hard chain's, mostly partial rounds): ``(x, b, prev, o)``, cloned
    as the round found them."""
    seen = []

    def capture(x, K, W1, b, prev, *, B, inner_max):
        if len(seen) == r:
            seen.append((x.clone(), b.clone(), prev.clone()))
        else:
            seen.append(None)
        return gs_round_oriented(x, K, W1, b, (len(seen) - 1) % 4, B=B,
                                 inner_max=inner_max, prev=prev,
                                 inplace=True)

    gs_solve(base, W, B, None, r + 1, capture, PitLinks(*links))
    x, b, prev = seen[r]
    return x, b, prev, r % 4


def k1_round_bound(inputs, outputs, W, share):
    """:func:`round_bound` of a round that visits ``share`` of the blocks
    (the bytes of the visited blocks' inputs and outputs, and their
    multiply-adds)."""
    bound, by = round_bound(inputs, outputs, W)
    return bound * share, by


def time_oriented_rounds(base, K, W1, W, card, state, B=64, plain=True):
    """K1 in the TPU's order at N_MAIN², block side ``B``, through the
    dataflow launch (at B = 128 and 256 a cluster a block), one round each,
    median of 5: from the base (every block relaxed) at each orientation,
    with ``plain`` the plain version beside it at orientation 0; a skipped
    round (no flag set); a partial round of the hard chain's pit solve
    (round 12); each round's bound, counting the blocks it visits; the
    critical path, the round at orientation 0 with the card held behind
    the host; the cone solve and the hard chain's pit solve.  Returns the
    figures."""
    kw = dict(B=B, inner_max=2 * B + 4)
    n = base.shape[0]

    def timed(what, args, prev=None):
        ms, reps = cuda_median_ms(
            lambda: gs_round_oriented(*args, **kw, prev=prev), reps=5)
        log("time", "%s: median %.4f ms, reps %s ms [%s]"
            % (what, ms, ["%.4f" % t for t in reps], card))
        return ms, gs_round_oriented(*args, **kw, prev=prev)[1]

    by_o = {}
    err = 0.0
    for o in range(4):
        what = ("K1 round in the TPU's order %d² B=%d orientation %d from "
                "the base (all blocks visited)" % (n, B, o))
        by_o[o], chg = timed(what, (base, K, W1, base, o))
    out, chg = gs_round_oriented(base, K, W1, base, 0, **kw)
    ones = torch.ones_like(chg)
    bound, bound_by = round_bound((base, K, W1, base, ones), (out, chg), W)
    res = dict(B=B, cluster=kernel_cluster_size(B), bound=bound,
               bound_by=bound_by, ms=by_o[0],
               ms_by_orientation=[by_o[o] for o in range(4)])
    res["plain_ms"] = None
    if plain:
        pms, preps = cuda_median_ms(
            lambda: gs_round_oriented_plain(base, K, W1, base, 0, **kw),
            reps=1)
        xp, cp = gs_round_oriented_plain(base, K, W1, base, 0, **kw)
        err = nan_equal_max_err(out, xp)
        check(err <= KERNEL_TOL and torch.equal(chg, cp),
              "timed round: dataflow != plain (max err %g)" % err)
        res["plain_ms"] = pms
        log("time", "K1 round %d² B=%d orientation 0 from the base, plain: "
            "%.1f ms [%s]" % (n, B, pms, card))
    res["err"] = err
    zero = torch.zeros_like(chg)
    res["skipped_ms"], _c = timed(
        "K1 skipped round %d² B=%d (no flag set)" % (n, B),
        (base, K, W1, base, 0), prev=zero)
    # a skipped round reads the flags and writes its own
    res["skipped_bound"] = 2 * zero.numel() * 4 / HBM_BYTES_PER_S * 1e3
    Wc, bc, links = state
    Kc, W1c = compact_from_dense(Wc)
    x, b, prev, o = partial_round(bc, Wc, links, B, 12)
    share = float(dilate(prev != 0).double().mean())
    res["partial_ms"], pchg = timed(
        "K1 partial round %d² B=%d, the hard chain's pit solve round 12 "
        "(%.1f%% of the blocks dirty)" % (n, B, 100 * share),
        (x, Kc, W1c, b, o), prev=prev)
    res["partial_share"] = share
    res["partial_bound"] = k1_round_bound((x, Kc, W1c, b, prev), (x, pchg),
                                          Wc, share)[0]
    res["critical_path_ms"] = statistics.median(
        [held_ms(lambda: gs_round_oriented(base, K, W1, base, 0, **kw), 1)
         for _ in range(4)][1:])
    res["solve_ms"], res["solve_rounds"] = solve_ms(
        lambda: accumulate_blocked_gs(base, W, B=B),
        "K1 cone solve %d² B=%d, dataflow" % (n, B), card)
    res["pit_solve_ms"], res["pit_solve_rounds"] = solve_ms(
        lambda: accumulate_blocked_pits_gs(bc, Wc, *links, B=B),
        "hard chain pit solve %d² B=%d, dataflow" % (n, B), card)
    # each solve's bound: its rounds from the base, each at the round's
    res["solve_bound"] = res["solve_rounds"] * bound
    res["pit_solve_bound"] = res["pit_solve_rounds"] * bound
    log("time", "K1 in the TPU's order %d² B=%d (a cluster of %d CTAs a "
        "block): from the base by orientation %s ms (bound %.4f ms by %s, "
        "%.1f%% of the round); skipped %.4f ms; partial (%.1f%% dirty) "
        "%.4f ms (bound %.4f); critical path held %.3f ms; cone solve %.3f "
        "ms (%d rounds, bound %.4f); pit solve %.3f ms (%d rounds, bound "
        "%.4f) [%s]"
        % (n, B, res["cluster"],
           ["%.3f" % t for t in res["ms_by_orientation"]], bound, bound_by,
           100 * bound / res["ms"], res["skipped_ms"], 100 * share,
           res["partial_ms"], res["partial_bound"], res["critical_path_ms"],
           res["solve_ms"], res["solve_rounds"], res["solve_bound"],
           res["pit_solve_ms"], res["pit_solve_rounds"],
           res["pit_solve_bound"], card))
    return res


def time_sweeps(device, card):
    """The time of one sweep of a block visit, under a CTA barrier (B = 64,
    one CTA) and in a cluster (128: 4 CTAs, 256: 16), each CTA sweeping
    4096 pixels: K2 on one B x B block whose every pixel sends all its flow
    east, so that a wave crosses the block one column a sweep and every
    4-sweep test finds change until sweep B; (the visit capped at B sweeps
    - at 4 sweeps) / (B - 4), CUDA events around 50 launches, median of 5.
    At 128 and 256 also the sweep probe (``probe_round``): each cluster
    visit of ``PROBE_VISITS``, timed alike in turns (the shipped visit
    first and last).  Returns ``({B: ms a sweep}, {B: {visit: ms a
    sweep}})``."""
    out, probe = {}, {}

    def sweep_ms(fn, B):
        # the card held behind the host while it queues the 50 launches
        # (:func:`held_ms`): a visit of 4 sweeps is shorter than a launch
        # from Python, and the host's time would count
        ms = {}
        for sweeps in (4, B):
            def fifty():
                for _ in range(50):
                    fn(sweeps)

            fifty()
            ms[sweeps] = statistics.median(
                held_ms(fifty, 50) for _ in range(5)) / 50
        return (ms[B] - ms[4]) / (B - 4), ms

    for B in (64, 128, 256):
        W = torch.zeros((8, B, B), device=device)
        W[0] = 1.0  # NEIGHBOR_OFFSETS[0]: east
        base = torch.ones((B, B), device=device)
        x, chg = block_round(base, W, base, B=B, inner_max=B)
        torch.cuda.synchronize()
        check(bool(chg.all()) and float(x[0, -1]) == B,
              "the sweep probe at B=%d did not sweep %d times" % (B, B))
        out[B], ms = sweep_ms(
            lambda k: block_round(base, W, base, B=B, inner_max=k), B)
        log("time", "one sweep of a block visit at B=%d (%s): %.3f us (a "
            "visit of 4 sweeps %.4f ms, of %d sweeps %.4f ms) [%s]"
            % (B, "one CTA, CTA barrier" if B == 64 else "a cluster of %d "
               "CTAs, edge rows as asynchronous stores counted on the "
               "neighbours' mbarriers" % kernel_cluster_size(B),
               1e3 * out[B], ms[4], B, ms[B], card))
        if B == 64:
            continue
        visits = uca_block.PROBE_VISITS
        reps = {v: [] for v in visits}
        for v in visits + visits[::-1]:
            def run(k, v=v):
                return uca_block.probe_round(base, W, base, B=B,
                                             inner_max=k, visit=v)
            if not reps[v]:
                xp, cp = run(B)
                torch.cuda.synchronize()
                if v in ("sweep", "async"):
                    check(torch.equal(xp, x) and torch.equal(cp, chg),
                          "the probe's %s visit at B=%d != K2" % (v, B))
            reps[v].append(sweep_ms(run, B)[0])
        probe[B] = {v: statistics.median(t) for v, t in reps.items()}
        log("time", "sweep probe at B=%d, us a sweep by visit (%s; the cut "
            "variants' values are wrong by design): %s [%s]"
            % (B, "in turns", {v: round(1e3 * t, 4)
                               for v, t in probe[B].items()}, card))
    return out, probe


def time_base_round(base, K, W1, W, card, B):
    """K1 in the TPU's order at N_MAIN², block side ``B``: one round from
    the base (every block visited) at orientation 0 through the dataflow
    launch, median of 5, beside its plain round (once, bitwise) and its
    bound.  For the mesh's B = 32 and 8, which no one-card path takes."""
    kw = dict(B=B, inner_max=2 * B + 4)
    ms, reps = cuda_median_ms(
        lambda: gs_round_oriented(base, K, W1, base, 0, **kw), reps=5)
    out, chg = gs_round_oriented(base, K, W1, base, 0, **kw)
    pms, _p = cuda_median_ms(
        lambda: gs_round_oriented_plain(base, K, W1, base, 0, **kw), reps=1,
        warmup=0)
    xp, cp = gs_round_oriented_plain(base, K, W1, base, 0, **kw)
    err = nan_equal_max_err(out, xp)
    check(err <= KERNEL_TOL and torch.equal(chg, cp),
          "timed round B=%d: dataflow != plain (max err %g)" % (B, err))
    bound, bound_by = round_bound((base, K, W1, base, torch.ones_like(chg)),
                                  (out, chg), W)
    log("time", "K1 round in the TPU's order %d² B=%d from the base: median "
        "%.3f ms, reps %s ms; plain %.1f ms; bound %.4f ms by %s [%s]"
        % (base.shape[0], B, ms, ["%.3f" % t for t in reps], pms, bound,
           bound_by, card))
    return dict(B=B, ms=ms, plain_ms=pms, bound=bound, bound_by=bound_by,
                err=err)


# the block sides of phase 8's K1 figures: 64 (one CTA a block), the
# cluster's 128 and the main path's default 256 (B = 16's rows were cut for
# the time limit); and the mesh's B = 32 and 8 (a round from the base)
TIMED_BLOCKS = (64, 128, 256)
MESH_BLOCKS = (32, 8)


def phase_times(device, card, state):
    """The hard chain's stages, K2 and K1 rounds, and the full pit solves;
    CUDA events."""
    elev = torch.from_numpy(make_cone(N_MAIN)).to(device)
    W, base = weights_and_base(elev)
    chain = time_chain(device, card)
    K, W1 = compact_from_dense(W)
    W = W.contiguous()
    # K2 at the solvers' default B = 256 and at 128, 64, 32, 16 and 8
    k2, k2_err = {}, 0.0
    for Bk in (256, 128, 64, 32, 16, 8):
        kw2 = dict(B=Bk, inner_max=2 * Bk + 4)
        k2[Bk], e = time_round(
            "first K2 round %d² B=%d (all blocks visited)" % (N_MAIN, Bk),
            (("kernel", block_round), ("plain", block_round_plain)),
            ((base, W, base), kw2), card)
        k2_err = max(k2_err, e)
        out, chg = block_round(base, W, base, **kw2)
        k2[Bk]["bound"], k2[Bk]["bound_by"] = round_bound((base, W, base),
                                                          (out, chg), W)
        log("time", "K2 round B=%d bound: %.4f ms by %s, %.1f%% of the "
            "kernel's %.3f ms" % (Bk, k2[Bk]["bound"], k2[Bk]["bound_by"],
                                  100 * k2[Bk]["bound"] / k2[Bk]["kernel"],
                                  k2[Bk]["kernel"]))
    k2[256]["by_block"] = {Bk: k2[Bk] for Bk in (128, 64, 32, 16, 8)}
    k2 = k2[256]
    # K1 in the TPU's order: the main path's B = 256 (beside its plain
    # round), and 64 and 128
    by_block = {Bt: time_oriented_rounds(base, K, W1, W, card, state, Bt)
                for Bt in TIMED_BLOCKS}
    k1 = dict(by_block[_block_size(N_MAIN, N_MAIN)])
    k1["by_block"] = by_block
    k1["sweep_ms"], k1["sweep_probe"] = time_sweeps(device, card)
    k1["mesh_blocks"] = {Bm: time_base_round(base, K, W1, W, card, Bm)
                         for Bm in MESH_BLOCKS}
    W, base, links = state
    k1["pit_solve"] = {}
    for name, fn in (
            ("K2 (accumulate_blocked_pits)",
             lambda: accumulate_blocked_pits(base, W, *links)),
            ("jacobi (accumulate)", lambda: accumulate(base, W, *links))):
        k1["pit_solve"][name] = solve_ms(
            fn, "pit solve, hard chain %d², %s" % (N_MAIN, name), card)
    return k2, k2_err, chain, k1


MANAGER_KW = dict(conditioning_backend="device", pit_backend="device",
                  uca_solver="blocked")
STORE_KEYS = ("elev", "aspect", "slope", "uca", "edge_todo", "edge_done",
              "uca_edges", "uca_edge_metrics", "twi", "success")
EXPORT_KEYS = ("elev", "aspect", "slope", "uca", "twi")
TIMED_PARTS = ("mosaic", "elevation", "aspect_slope", "uca", "twi",
               "uploads", "store_writes", "export", "total")


class TimedStore(ArrayStore):
    """An ArrayStore that adds up the seconds of its whole-array writes."""

    write_seconds = 0.0

    def __setitem__(self, name, data):
        t0 = time.perf_counter()
        super().__setitem__(name, data)
        self.write_seconds += time.perf_counter() - t0


def manager_run(tiles, work, tag, **kw):
    """One run of the manager path through its entry points: tiles in,
    ``process_twi``, GeoTIFFs out.  Returns the manager, the twi, the written
    files and the seconds of each part (host clock; the device is
    synchronised at the end of the pipeline and around every upload, which
    is how the uploads are timed)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "pits had no place to drain"
        t_all = time.perf_counter()
        pm = ProcessManager(in_path=tiles,
                            out_path=os.path.join(work, tag + ".zarr"), **kw)
        pm.out_file = TimedStore(pm.out_path)
        pm.compute_grid()
        t0 = time.perf_counter()
        dp = pm._processor()  # reads the tiles and mosaics them
        mosaic_s = time.perf_counter() - t0
        upload = {"seconds": 0.0, "bytes": 0}
        to_dev = dp._to_dev

        def timed_to_dev(a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = to_dev(a)
            torch.cuda.synchronize()
            upload["seconds"] += time.perf_counter() - t0
            upload["bytes"] += out.numel() * out.element_size()
            return out

        dp._to_dev = timed_to_dev
        twi = pm.process_twi()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        written = pm.save_non_overlap_data_geotiff(
            os.path.join(work, tag + "_geotiff"))
        export_s = time.perf_counter() - t0
        total_s = time.perf_counter() - t_all
    times = dict(pm.timer.report(), mosaic=mosaic_s,
                 uploads=upload["seconds"], upload_bytes=upload["bytes"],
                 store_writes=pm.out_file.write_seconds, export=export_s,
                 total=total_s)
    return pm, twi, written, times


def gate_equal(name, got, want, tol):
    """NaN pattern equal and values within ``tol``; returns (max abs
    difference, bitwise equal)."""
    got, want = np.asarray(got), np.asarray(want)
    check(np.array_equal(np.isnan(got), np.isnan(want)),
          "%s: NaN patterns differ" % name)
    g, w = np.nan_to_num(got), np.nan_to_num(want)
    check(np.allclose(g, w, **tol), "%s differ beyond %s (max abs %g)"
          % (name, tol, np.abs(g - w).max()))
    return float(np.abs(g - w).max()), bool(np.array_equal(g, w))


def f32_envelope_stats(ref, got):
    """(relative p99, share above 1e-3) of ``got`` against the float64
    ``ref`` over their finite pixels, as ``tests/test_parity_f32.py`` of the
    JAX package measures them."""
    ref, got = np.asarray(ref, "float64"), np.asarray(got, "float64")
    ok = np.isfinite(ref) & np.isfinite(got)
    rel = np.abs(ref[ok] - got[ok]) / np.maximum(np.abs(ref[ok]), 1e-30)
    return float(np.quantile(rel, 0.99)), float((rel > 1e-3).mean())


def check_manager_store(pm, hard, launches):
    """The checked run's grid, mosaic, launches and store."""
    check(pm.compute_grid() == (N_MAIN, N_MAIN),
          "compute_grid gave %s" % (pm.grid_shape,))
    check(np.array_equal(pm._mosaic_elev(), hard.astype("float64")),
          "the mosaic of the tiles is not the unsplit array")
    rounds = pm._dp.uca_sweeps
    check(0 < rounds <= launches <= rounds + 3,
          "the manager path launched K1 %d times for %d rounds"
          % (launches, rounds))
    store = pm.out_file
    for key in STORE_KEYS:
        check(key in store, "the store lacks %r" % key)
    success = store["success"]
    check(success.shape == (pm.n_inputs, 4) and bool(success.all()),
          "success is %s" % (success.tolist(),))
    for key in ("elev", "aspect", "slope", "uca", "twi", "edge_todo",
                "edge_done", "uca_edges"):
        check(store._meta(key)["shape"] == [N_MAIN, N_MAIN],
              "store %s has shape %s" % (key, store._meta(key)["shape"]))
    log("manager", "%d tiles -> grid %s, %d K1 launches for %d rounds, store "
        "holds %s, success all True" % (pm.n_inputs, pm.grid_shape, launches,
                                        rounds, ", ".join(STORE_KEYS)))
    return store


def check_manager_exports(pm, store, written):
    check([os.path.basename(f) for f in written]
          == [k + ".tif" for k in EXPORT_KEYS], "exported %s" % (written,))
    for key, fn in zip(EXPORT_KEYS, written):
        g = read_geotiff(fn)
        ref = store[key].astype("float32")
        check(g.data.dtype == np.float32 and np.array_equal(
            g.data, np.where(np.isnan(ref), np.float32(-9999), ref)),
            "%s.tif does not read back to the store's array" % key)
        check(g.nodata == -9999 and tuple(g.transform) == tuple(pm.transform),
              "%s.tif: nodata %s, transform %s" % (key, g.nodata,
                                                   g.transform))
        for k, fac in enumerate((3, 9, 27), start=1):
            ov = read_geotiff(fn, ifd_index=k, header_only=True)
            check(ov.shape == (N_MAIN // fac, N_MAIN // fac),
                  "%s.tif overview %d has shape %s" % (key, fac, ov.shape))
    log("manager", "5 GeoTIFFs read back to the store's arrays (float32, NaN "
        "as -9999), each with overview IFDs 3, 9, 27 and the mosaic's "
        "transform; %d no-data px in uca.tif"
        % int(np.isnan(store["uca"]).sum()))


def check_manager_edge_done(pm, store):
    """edge_done == ~reachability(edge_todo) through the solve's links, with
    no-data pixels done."""
    dp = pm._dp
    section, proportion, pits, _min_area = dp._edge_flood_args
    check(pits[0] is not None and bool((pits[2] > 0).all()),
          "the manager's solve kept no pit links for the flood")
    elev_d = dp._field_dev("elev")
    W = receiver_weights(section, proportion, elev_d)
    flood = reachability(dp._field_dev("edge_todo"), W, *pits)
    done = ~flood.cpu().numpy()
    done[np.isnan(store["elev"])] = True
    check(np.array_equal(store["edge_todo"], dp.edge_todo),
          "the store's edge_todo is not the solve's")
    check(np.array_equal(store["edge_done"], done),
          "edge_done is not the complement of the flooded edge_todo")
    log("manager", "edge_done == ~reachability(edge_todo) through %d links: "
        "%d todo px on the mosaic's boundary, %d px not done"
        % (pits[0].numel(), int(store["edge_todo"].sum()),
           int((~done).sum())))


def check_host_backends(device, work):
    """The default (host) backends through the manager at 256² with the
    tensors on the card, against the same run on the CPU in float64."""
    n = 256
    for name, elev in (("noisy cone", make_noisy_cone(n)),
                       ("hard", make_hard_terrain(n, "float32"))):
        tag = name.replace(" ", "_")
        tiles = os.path.join(work, "tiles_%s" % tag)
        write_tiles(elev, tiles)
        reset_counts()
        card_pm, _t, _w, _s = manager_run(tiles, work, tag + "_card")
        launches = launch_count(gs_round_oriented)
        cpu_pm, _t, _w, _s = manager_run(tiles, work, tag + "_cpu",
                                         device="cpu")
        check(card_pm._dp.device.type == "cuda" and launches > 0
              and card_pm._dp._dev("uca") is None,
              "%s: the host-state route did not run K1 on the card" % name)
        a, b = cpu_pm.out_file, card_pm.out_file
        check(np.array_equal(a["elev"], b["elev"], equal_nan=True),
              "%s: host conditioning differs between the runs" % name)
        stats = {}
        for key in ("slope", "aspect", "uca", "twi"):
            check(np.array_equal(np.isnan(a[key]), np.isnan(b[key])),
                  "%s: %s NaN pattern differs from the CPU run" % (name, key))
            stats[key] = f32_envelope_stats(a[key], b[key])
        same = {k: float((a[k] == b[k]).mean())
                for k in ("edge_todo", "edge_done")}
        if name == "noisy cone":
            check(stats["slope"][0] < 1e-5 and stats["aspect"][0] < 1e-4
                  and stats["aspect"][1] < 0.02 and stats["uca"][0] < 0.25
                  and stats["twi"][0] < 0.06,
                  "%s: card float32 outside the f32 envelope: %s"
                  % (name, stats))
        log("manager", "host backends, %s %d², card float32 vs CPU float64: "
            "elev and NaN patterns equal, %d K1 launches, (rel p99, share > "
            "1e-3) = %s, equal share of edge masks %s%s"
            % (name, n, launches, stats, same,
               ", inside the f32 envelope" if name == "noisy cone" else
               " (float32 takes this terrain outside the envelope on any "
               "device; printed, not gated)"))


def phase_manager(device, card):
    """Phase 9: the manager path at 2048² over a 2×2 tile grid."""
    work = tempfile.mkdtemp(prefix="pydem_smoke_")
    try:
        return _phase_manager(device, card, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _phase_manager(device, card, work):
    hard = make_hard_terrain(N_MAIN, "float32")
    tiles = os.path.join(work, "tiles")
    check(write_tiles(hard, tiles) == 4, "expected a 2x2 tile grid")

    reset_counts()
    pm, twi, written, times0 = manager_run(tiles, work, "run0",
                                           dem_proc_kwargs=MANAGER_KW)
    launches = main_launches("9 manager")
    check(pm._dp.device.type == device.type == "cuda",
          "the manager ran on %s" % pm._dp.device)
    store = check_manager_store(pm, hard, launches)
    with open(os.path.join(pm.out_path, "metrics.json")) as f:
        metrics0 = json.load(f)
    check(sorted(metrics0["stage_seconds"]) == ["aspect_slope", "elevation",
                                                "twi", "uca"],
          "metrics.json stages: %s" % metrics0["stage_seconds"])

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dX, dY, dX2, dY2 = pm._pixel_vectors()
        one = DEMProcessor(elev=hard.astype("float64"), dX=dX, dY=dY, dX2=dX2,
                           dY2=dY2, **MANAGER_KW)
        one.calc_twi()
    for key, got, want in (("uca", store["uca"], one.uca),
                           ("twi", store["twi"], one.twi)):
        err, bitwise = gate_equal("manager %s vs one DEMProcessor" % key, got,
                                  want, GATE_TOL["hard"])
        log("manager", "%s of the tiled mosaic vs one DEMProcessor on the "
            "unsplit array: within %s, NaN pattern equal, max abs %g, "
            "bitwise equal: %s" % (key, GATE_TOL["hard"], err, bitwise))
    check(np.array_equal(np.nan_to_num(np.asarray(twi)),
                         np.nan_to_num(store["twi"])),
          "process_twi did not return the stored twi")
    check_manager_exports(pm, store, written)
    check_manager_edge_done(pm, store)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pm2 = ProcessManager(in_path=tiles, out_path=pm.out_path, resume=True,
                             dem_proc_kwargs=MANAGER_KW)
        t0 = time.perf_counter()
        twi2 = pm2.process_twi()
        resume_s = time.perf_counter() - t0
    with open(os.path.join(pm.out_path, "metrics.json")) as f:
        stage_s = json.load(f)["stage_seconds"]
    check(all(v < 0.05 for v in stage_s.values()) and not pm2.timer.report(),
          "the resumed run ran stages again: %s" % stage_s)
    check(np.array_equal(np.asarray(twi2), store["twi"], equal_nan=True),
          "the resumed run's twi is not bitwise the first run's")
    log("manager", "resume=True: every stage skipped (stage seconds %s), twi "
        "bitwise equal, %.3f s" % (stage_s, resume_s))

    cli_out = os.path.join(work, "cli_geotiff")
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "pydem_tpu_torch.cli", "process", tiles,
         "--store", os.path.join(work, "cli.zarr"), "--out", cli_out],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=900)
    cli_s = time.perf_counter() - t0
    check(cli.returncode == 0, "the CLI exited with %d: %s"
          % (cli.returncode, cli.stderr[-2000:]))
    check(sorted(os.listdir(cli_out)) == sorted(k + ".tif"
                                                for k in EXPORT_KEYS),
          "the CLI wrote %s" % sorted(os.listdir(cli_out)))
    cli_uca = read_geotiff(os.path.join(cli_out, "uca.tif"))
    check(cli_uca.shape == (N_MAIN, N_MAIN)
          and tuple(cli_uca.transform) == tuple(pm.transform),
          "the CLI's uca.tif: shape %s" % (cli_uca.shape,))
    ref = store["uca"].astype("float32")
    both = (cli_uca.data != -9999) & ~np.isnan(ref)
    rel = np.abs(cli_uca.data[both] - ref[both]) / np.abs(ref[both])
    log("manager", "python -m pydem_tpu_torch.cli process <dir> (default "
        "device, host backends, %d²): exit 0, the same five files, %.1f s "
        "[%s]; its uca vs the device backends' uca (another conditioning "
        "arithmetic, so flow paths through filled flats may differ; printed, "
        "not gated): relative p50 %.3g, p90 %.3g, share above 1e-3 %.4f over "
        "%d common px"
        % (N_MAIN, cli_s, card, np.quantile(rel, 0.5), np.quantile(rel, 0.9),
           float((rel > 1e-3).mean()), int(both.sum())))

    check_host_backends(device, work)

    reps = []
    for k in range(1, 4):
        tag = "run%d" % k
        _pm, _twi, _written, t = manager_run(tiles, work, tag,
                                             dem_proc_kwargs=MANAGER_KW)
        reps.append(t)
        shutil.rmtree(os.path.join(work, tag + ".zarr"))
        shutil.rmtree(os.path.join(work, tag + "_geotiff"))
    for part in TIMED_PARTS:
        log("time", "manager path %d², %-12s median %.3f s, reps %s s, "
            "checked first run %.3f s [%s]"
            % (N_MAIN, part, statistics.median(r[part] for r in reps),
               ["%.3f" % r[part] for r in reps], times0[part], card))
    log("time", "manager path %d²: %.1f MB uploaded a run (the elevation "
        "stage and the slope stage each upload the canvas: host state sits "
        "between the manager's stages), %.4g px/s end to end [%s]"
        % (N_MAIN, reps[0]["upload_bytes"] / 1e6,
           N_MAIN * N_MAIN / statistics.median(r["total"] for r in reps),
           card))
    return launches


# -- phase 10: the out-of-core engine ---------------------------------------

OOC_FREE_BYTES = 8 << 30  # room the two 8192² stores need, with slack


def ring_window(x, K, W1, base, i0, j0, S, w=None):
    """The (S+2)² window at (i0, j0) of a canvas's planes (``w``: S+2 rows
    by w+2 columns), cut as the out-of-core engine reads it: beyond the
    canvas x is 0 (a sanitised NaN), K is "no edge" and W1 is 0; ``base``
    covers the S² (S × w) region."""
    pad = torch.nn.functional.pad
    w = S if w is None else w
    sl = (slice(i0, i0 + S + 2), slice(j0, j0 + w + 2))
    x_win = torch.nan_to_num(pad(x, (1, 1, 1, 1), value=float("nan"))[sl])
    return (x_win.contiguous(),
            pad(K, (1, 1, 1, 1), value=255)[sl].contiguous(),
            pad(W1, (1, 1, 1, 1))[sl].contiguous(),
            base[i0: i0 + S, j0: j0 + w].contiguous())


def phase_ring_round(device, card, k1_ms):
    """10a: K1's ring form in the TPU's order on 2048² windows of the 4096²
    cone, from a mid-solve state: the dataflow launch == the plain version
    at two orientations, the ring untouched; one ring round from the base
    timed.  Returns (times, max error)."""
    n, S, B = 2 * S_OOC, S_OOC, 64
    elev = torch.from_numpy(make_cone(n)).to(device)
    W, base = weights_and_base(elev)
    K, W1 = compact_from_dense(W)
    del W, elev
    kw = dict(B=B, inner_max=2 * B + 4)
    x, _chg = gs_round_oriented(base, K, W1, base, 0, **kw)  # mid-solve
    worst = 0.0
    for where, (i0, j0) in (("interior", (S // 2, S // 2)),
                            ("corner", (0, 0))):
        args = ring_window(x, K, W1, base, i0, j0, S)
        ring = torch.ones_like(args[0], dtype=torch.bool)
        ring[1:-1, 1:-1] = False
        changed = []
        for o in (1, 2):
            err, xd, cd = oriented_vs_plain("10a ring round, %s window" % where,
                                            args, o, B, True, "all")
            worst = max(worst, err)
            check(torch.equal(xd[ring], args[0][ring]),
                  "ring round, %s window: the ring was written" % where)
            changed.append(int(cd.sum()))
        log("ooc", "10a ring round in the TPU's order, %s %d² window of the "
            "%d² cone, B=%d: dataflow == plain bitwise at "
            "orientations 1 and 2, ring untouched, %s of %d blocks changed"
            % (where, S, n, B, changed, cd.numel()))
    xw, Kw, W1w, bw = ring_window(base, K, W1, base, S // 2, S // 2, S)
    times = {}
    times["kernel"], reps = cuda_median_ms(
        lambda: gs_round_oriented(xw, Kw, W1w, bw, 0, ring=True, **kw),
        reps=5)
    log("time", "10a ring round %d² window B=%d from the base, dataflow: "
        "median %.3f ms, reps %s [%s]"
        % (S, B, times["kernel"], ["%.3f" % t for t in reps], card))
    times["plain"], _r = cuda_median_ms(
        lambda: gs_round_oriented_plain(xw, Kw, W1w, bw, 0, ring=True, **kw),
        reps=1)
    out, chg = gs_round_oriented(xw, Kw, W1w, bw, 0, ring=True, **kw)
    nbytes = sum(t.numel() * t.element_size()
                 for t in (xw, Kw, W1w, bw, torch.ones_like(chg), out, chg))
    times["bound"] = nbytes / HBM_BYTES_PER_S * 1e3
    log("time", "10a ring round %.3f ms (plain %.1f) beside the %d² canvas "
        "round %.3f ms (phase 8, this run): ratio %.3f; bound %.4f ms by "
        "bytes (%.1f MB), %.1f%% of the kernel's time [%s]"
        % (times["kernel"], times["plain"], N_MAIN,
           k1_ms["ms"], times["kernel"] / k1_ms["ms"], times["bound"],
           nbytes / 1e6, 100 * times["bound"] / times["kernel"], card))
    return times, worst


class CountingStore(ArrayStore):
    """An ArrayStore that adds up the bytes and seconds of its window reads
    and writes (called from the engine's IO thread and the main thread)."""

    def __init__(self, root):
        super().__init__(root)
        self.io = dict(read_bytes=0, read_s=0.0, write_bytes=0, write_s=0.0)
        self._lock = threading.Lock()

    def _add(self, kind, nbytes, t0):
        with self._lock:
            self.io[kind + "_bytes"] += nbytes
            self.io[kind + "_s"] += time.perf_counter() - t0

    def read_window(self, name, rows, cols):
        t0 = time.perf_counter()
        out = super().read_window(name, rows, cols)
        self._add("read", out.nbytes, t0)
        return out

    def write_window(self, name, data, offset):
        t0 = time.perf_counter()
        super().write_window(name, data, offset)
        meta = self._meta(name)
        self._add("write", np.asarray(data).size
                  * np.dtype(meta["dtype"]).itemsize, t0)


def ooc_run(work, tag, elev, S, budget, time_kernel=False, mesh=None,
            **opts):
    """``elev`` (a numpy array, or a tensor written window by window) into
    a fresh store by S² windows, then one ``OutOfCoreEngine(...).run()`` on
    the default device (over ``mesh``, if given) with unit pixels.  Returns
    the store, the engine and what the run took (``fused``: whether the
    device-resident pass ran; ``peak_on``: each card's peak)."""
    n, m = elev.shape
    store = CountingStore(os.path.join(work, tag + ".zarr"))
    store.create("elev_src", elev.shape, "float64", chunks=(S, S),
                 fill=np.nan, overwrite=True, compress=False)
    for i0 in range(0, n, S):
        for j0 in range(0, m, S):
            w = elev[i0: i0 + S, j0: j0 + S]
            if isinstance(w, torch.Tensor):
                w = w.cpu().numpy()
            store.write_window("elev_src", w.astype("float64"), (i0, j0))
    store.io.update(read_bytes=0, read_s=0.0, write_bytes=0, write_s=0.0)
    cards = ([torch.device("cuda", 0)] if mesh is None
             else [d for d, _ks in mesh.devices_of()])
    timer = StageTimer()
    spans, visit_rounds = [], []

    def visit_round(*args, **kw):
        """The streamed visits' rounds (the engine's own name for K1),
        counted, and timed with ``time_kernel``."""
        visit_rounds.append(1)
        if not time_kernel:
            return gs_round_oriented(*args, **kw)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = gs_round_oriented(*args, **kw)
        end.record()
        spans.append((start, end))
        return res

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "pits had no place to drain"
        eng = OutOfCoreEngine(store, elev.shape, np.ones(n - 1),
                              np.ones(n - 1), np.ones(n), np.ones(n),
                              dem_proc_kwargs=opts, superblock=S,
                              device_cache_bytes=budget, timer=timer,
                              mesh=mesh)
        check(eng.device.type == "cuda" and eng._work_dtype == "float32",
              "the engine runs on %s in %s" % (eng.device, eng._work_dtype))
        fused = []
        run_fused = eng._run_fused_device
        eng._run_fused_device = lambda: fused.append(1) or run_fused()
        gc.collect()
        held = {}
        for d in cards:  # what earlier phases keep
            torch.cuda.synchronize(d)
            torch.cuda.reset_peak_memory_stats(d)
            held[d] = torch.cuda.memory_allocated(d)
        reset_counts()
        outofcore.gs_round_oriented = visit_round
        try:
            t0 = time.perf_counter()
            eng.run()
            for d in cards:
                torch.cuda.synchronize(d)
            total = time.perf_counter() - t0
        finally:
            outofcore.gs_round_oriented = gs_round_oriented
    peak_on = {d: torch.cuda.max_memory_allocated(d) - held[d] for d in cards}
    # launches: every dataflow launch of the run (the fused pass's in-core
    # or sharded solve, the streamed visits); ring_launches: the streamed
    # visits' rounds alone
    res = dict(total=total, stages=timer.report(), rounds=eng.uca_rounds,
               visits=eng.uca_visits, skipped=eng.uca_skipped,
               launches=main_launches("10 engine %s" % tag),
               ring_launches=len(visit_rounds),
               on=dict(gs_round_oriented.launches_on),
               counts=counts_by_card(),
               peak=peak_on[cards[0]], peak_on=peak_on, fused=bool(fused),
               io=dict(store.io),
               kernel_s=sum(a.elapsed_time(b) for a, b in spans) / 1e3)
    return store, eng, res


def ooc_report(tag, n, S, res, card):
    io = res["io"]
    log("ooc", "%s %d² S=%d: total %.3f s, stage seconds %s, %d outer "
        "rounds, %d visits made and %d skipped by the frontier, K1 dataflow "
        "launches %d (%d of them the streamed visits' ring rounds) [%s]"
        % (tag, n, S, res["total"],
           {k: round(v, 3) for k, v in res["stages"].items()}, res["rounds"],
           res["visits"], res["skipped"], res["launches"],
           res["ring_launches"], card))
    log("ooc", "%s %d²: store window reads %.1f MB in %.3f s (%.0f MB/s "
        "summed over calls), writes %.1f MB in %.3f s (%.0f MB/s); peak "
        "device memory %.3f GB = %.1f planes of the canvas [%s]"
        % (tag, n, io["read_bytes"] / 1e6, io["read_s"],
           io["read_bytes"] / 1e6 / max(io["read_s"], 1e-9),
           io["write_bytes"] / 1e6, io["write_s"],
           io["write_bytes"] / 1e6 / max(io["write_s"], 1e-9),
           res["peak"] / 1e9, res["peak"] / (n * n * 4.0), card))


OOC_OPTS = dict(fill_flats=False, drain_pits_path=False)


def phase_ooc_scale(device, card):
    """10b: the big cone through the engine in both regimes."""
    work = tempfile.mkdtemp(prefix="pydem_smoke_ooc_")
    try:
        n, S = N_OOC, S_OOC
        free = shutil.disk_usage(work).free
        if free < OOC_FREE_BYTES:
            n, S = n // 2, S // 2
            log("ooc", "10b: the temporary directory has %.1f GB free, "
                "running %d² with S=%d instead of %d²" % (free / 1e9, n, S,
                                                          N_OOC))
        return _phase_ooc_scale(device, card, work, n, S)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _phase_ooc_scale(device, card, work, n, S):
    # the factor of _fits_device_resident: the fused pass's peak, in planes
    for small in (N_MAIN, 2 * N_MAIN):
        tag = "probe%d" % small
        _store, eng, res = ooc_run(work, tag, make_cone(small), small // 4,
                                   None, **OOC_OPTS)
        check(eng._fits_device_resident() and res["ring_launches"] == 0,
              "the %d² probe did not take the fused pass" % small)
        log("ooc", "10b fused pass %d²: peak device memory %.3f GB = %.1f "
            "planes of the canvas (the engine budgets %d) [%s]"
            % (small, res["peak"] / 1e9, res["peak"] / (small * small * 4.0),
               outofcore._DEVICE_RESIDENT_PLANES, card))
        check(res["peak"] <= outofcore._DEVICE_RESIDENT_PLANES * small
              * small * 4, "the fused pass at %d² exceeds the engine's "
              "memory factor" % small)
        shutil.rmtree(os.path.join(work, tag + ".zarr"))

    elev = make_cone(n)
    s_str, e_str, streamed = ooc_run(work, "streamed", elev, S, 0,
                                     time_kernel=True, **OOC_OPTS)
    check(not e_str._fits_device_resident()
          and streamed["launches"] == streamed["ring_launches"] > 0
          and streamed["visits"] > 0,
          "budget 0 did not stream: %s" % streamed)
    ooc_report("10b streamed (budget 0)", n, S, streamed, card)
    uca_s = streamed["stages"]["uca"]
    log("ooc", "10b streamed uca stage: %.3f s wall, %.3f s of ring-kernel "
        "time summed over %d launches (CUDA events): the kernel ran in "
        "%.1f%% of the stage; %.3f s a visit [%s]"
        % (uca_s, streamed["kernel_s"], streamed["ring_launches"],
           100 * streamed["kernel_s"] / uca_s, uca_s / streamed["visits"],
           card))
    s_fus, e_fus, fused = ooc_run(work, "fused", elev, S, None, **OOC_OPTS)
    check(e_fus._fits_device_resident() and fused["ring_launches"] == 0
          and fused["launches"] > 0, "the card's own budget (%d bytes) did "
          "not take the fused pass: %s" % (e_fus.device_cache_bytes, fused))
    check(fused["peak"] <= outofcore._DEVICE_RESIDENT_PLANES * n * n * 4,
          "the fused pass exceeds the engine's memory factor")
    ooc_report("10b fused (budget %.1f GB)" % (e_fus.device_cache_bytes / 1e9),
               n, S, fused, card)
    check(len(e_str._links[0]) == len(e_fus._links[0]) == 0,
          "the cone has pit links")

    uca = None
    for key in ("slope", "aspect", "flats", "uca", "twi"):
        a, b = s_str[key], s_fus[key]
        check(a.shape == (n, n) and a.dtype == b.dtype
              and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"),
              "10b: %s of the streamed and the fused regime differ" % key)
        if key == "uca":
            uca = b
    check(uca.dtype == np.float32, "uca is stored as %s" % uca.dtype)
    flats = s_fus["flats"]
    check(bool((np.isfinite(uca) | flats).all()) and bool(
        (uca[np.isfinite(uca)] > 0).all()), "10b: uca not finite and "
        "positive outside flats")
    step = terrain_step(torch.from_numpy(elev).to(device),
                        *spacing(n, torch.float32, device),
                        uca_solver="blocked")
    err, bitwise = gate_equal("10b engine uca vs terrain_step", uca,
                              step["uca"].cpu().numpy(), GATE_TOL["cone"])
    log("ooc", "10b %d²: slope, aspect, flats, uca, twi of the two regimes "
        "bitwise equal (NaN patterns with them); uca vs terrain_step(blocked) "
        "on the whole canvas within %s, max abs %g, bitwise equal: %s, %d "
        "rounds vs %d" % (n, GATE_TOL["cone"], err, bitwise, fused["rounds"],
                          step["uca_sweeps"]))
    return streamed["launches"] + fused["launches"]


OOC_STORE_KEYS = STORE_KEYS + ("elev_src", "flats", "uca_state")


def phase_ooc_hard(device, card):
    """10c: the hard terrain's tiles through the out-of-core manager."""
    work = tempfile.mkdtemp(prefix="pydem_smoke_ooc_")
    try:
        return _phase_ooc_hard(device, card, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _phase_ooc_hard(device, card, work):
    S = 512
    hard = make_hard_terrain(N_MAIN, "float32")
    tiles = os.path.join(work, "tiles")
    check(write_tiles(hard, tiles) == 4, "expected a 2x2 tile grid")
    kw = dict(in_path=tiles, out_path=os.path.join(work, "ooc.zarr"),
              out_of_core=True, superblock=S)
    reset_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t0 = time.perf_counter()
        pm = ProcessManager(**kw)
        store = pm.process_twi()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        written = pm.save_non_overlap_data_geotiff(
            os.path.join(work, "ooc_geotiff"))
        export_s = time.perf_counter() - t0
    launches = main_launches("10c out-of-core manager")
    eng = pm._ooc
    check(eng.device.type == "cuda" and eng._fits_device_resident()
          and launches > 0,
          "the out-of-core manager did not run on the card")
    check(pm.grid_shape == (N_MAIN, N_MAIN) and store is pm.out_file,
          "out-of-core manager: grid %s" % (pm.grid_shape,))
    check(np.array_equal(store["elev_src"], hard.astype("float64")),
          "the ingested canvas is not the unsplit array")
    for key in OOC_STORE_KEYS:
        check(key in store, "the out-of-core store lacks %r" % key)
    check(bool(store["success"].all()), "success is not all True")
    with open(os.path.join(pm.out_path, "metrics.json")) as f:
        metrics = json.load(f)
    check(metrics["uca_iters_to_converge"] == eng.uca_rounds
          and abs(metrics["halo_fraction"] - eng.halo_fraction()) < 1e-12,
          "metrics.json: %s" % metrics)
    check_manager_exports(pm, store, written)
    n_links = len(eng._links[0])
    check(n_links > 0, "the conditioned hard terrain has no pit links")
    log("ooc", "10c ProcessManager(out_of_core=True, superblock=%d) on the "
        "%d² hard terrain's 4 tiles: %.1f s, stage seconds %s, %d rounds, "
        "%d K1 launches, %d pit links, export %.1f s [%s]"
        % (S, N_MAIN, run_s, {k: round(v, 2) for k, v
                              in metrics["stage_seconds"].items()},
           eng.uca_rounds, launches, n_links, export_s, card))

    uca_dev, twi_dev = store["uca"], store["twi"]
    reset_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pm2 = ProcessManager(resume=True, **kw)
        t0 = time.perf_counter()
        pm2.process_twi()
        resume_s = time.perf_counter() - t0
    check(launch_count(gs_round_oriented) == 0
          and sorted(pm2.timer.report()) == ["ingest"]
          and pm2._ooc.uca_rounds == eng.uca_rounds,
          "the resumed out-of-core run computed again: %s"
          % pm2.timer.report())
    check(np.array_equal(store["uca"], uca_dev, equal_nan=True)
          and np.array_equal(store["twi"], twi_dev, equal_nan=True),
          "the resumed run changed the store")
    log("ooc", "10c resume=True: nothing recomputed (no launch, no stage "
        "but the skipped ingest), %.3f s" % resume_s)

    # the uca stage again on the same store, streamed
    eng.device_cache_bytes = 0
    check(not eng._fits_device_resident(), "budget 0 still fits")
    reset_counts()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng.uca()
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    ring_launches = launch_count(gs_round_oriented)
    check(ring_launches > 0 and eng.uca_visits > 0,
          "the streamed uca stage launched no ring round")
    uca_str = np.where(store["flats"], np.nan, store["uca_state"])
    err, bitwise = gate_equal("10c streamed vs device-resident uca", uca_str,
                              uca_dev, GATE_TOL["hard"])
    log("ooc", "10c uca stage on the same store, streamed (S=%d, %d outer "
        "rounds, %d visits, %d skipped, %d ring launches, %.1f s) vs "
        "device-resident (%d rounds): within %s, NaN pattern equal, %d pit "
        "links, max abs difference %g, bitwise equal: %s [%s]"
        % (S, eng.uca_rounds, eng.uca_visits, eng.uca_skipped, ring_launches,
           stream_s, metrics["uca_iters_to_converge"], GATE_TOL["hard"],
           n_links, err, bitwise, card))
    return launches + ring_launches


def phase_ooc_precision(device):
    """10d: the engine on the card in float32 against the CPU in float64
    (S = 128: the card's block size, 128, divides it)."""
    n, S = 256, 128
    work = tempfile.mkdtemp(prefix="pydem_smoke_ooc_")
    try:
        for name, elev in (("noisy cone", make_noisy_cone(n)),
                           ("hard", make_hard_terrain(n, "float32"))):
            tag = name.replace(" ", "_")
            s_card, e_card, res = ooc_run(work, tag + "_card", elev, S, 0)
            store = ArrayStore(os.path.join(work, tag + "_cpu.zarr"))
            store["elev_src"] = elev.astype("float64")
            one = np.ones(n)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                e_cpu = OutOfCoreEngine(store, elev.shape, one[1:], one[1:],
                                        one, one, superblock=S,
                                        device_cache_bytes=0, device="cpu")
                e_cpu.run()
                core = DEMProcessor(elev=elev.astype("float64"))
                core.calc_twi()
            check(e_cpu._work_dtype == "float64" and res["ring_launches"] > 0,
                  "10d %s: regimes" % name)
            check(np.array_equal(store["elev"], s_card["elev"],
                                 equal_nan=True),
                  "10d %s: host conditioning differs between the runs" % name)
            stats = {}
            for key in ("slope", "aspect", "uca", "twi"):
                check(np.array_equal(np.isnan(store[key]),
                                     np.isnan(s_card[key])),
                      "10d %s: %s NaN pattern differs from the CPU run"
                      % (name, key))
                stats[key] = f32_envelope_stats(store[key], s_card[key])
            core_stats = f32_envelope_stats(core.uca, s_card["uca"])
            nan_match = np.array_equal(np.isnan(core.uca),
                                       np.isnan(s_card["uca"]))
            if name == "noisy cone":
                check(stats["slope"][0] < 1e-5 and stats["aspect"][0] < 1e-4
                      and stats["aspect"][1] < 0.02 and stats["uca"][0] < 0.25
                      and stats["twi"][0] < 0.06,
                      "10d %s: card float32 outside the f32 envelope: %s"
                      % (name, stats))
                check(s_card["uca"].dtype == np.float32 and nan_match
                      and core_stats[0] < 1e-3, "10d %s: engine vs in-core "
                      "float32 uca: NaN match %s, rel p99 %g"
                      % (name, nan_match, core_stats[0]))
            log("ooc", "10d %s %d² S=%d, engine on the card (float32, "
                "streamed, %d ring launches) vs on the CPU (float64): elev "
                "and NaN patterns equal, (rel p99, share > 1e-3) = %s; uca "
                "vs the in-core float32 DEMProcessor: NaN match %s, rel p99 "
                "%.3g%s" % (name, n, S, res["ring_launches"], stats,
                            nan_match, core_stats[0],
                            ", inside the f32 envelope" if name == "noisy cone"
                            else " (printed, not gated)"))
    finally:
        shutil.rmtree(work, ignore_errors=True)


# -- phase 11: the mesh path ------------------------------------------------

N_MESH = 8192  # the sharded canvas: four 4096² shards on one card


def subset_bound(blocks, B, S):
    """The least time, in ms, of a K1 round over ``blocks`` (flat indices on
    an (S/B)² grid) of an S² region (``S``: or an (h, w) pair) with a 1-px
    ring, by bytes: the x, K and W1 pixels their (B+2)² windows read (each
    once), their base, their output blocks, their flags and the flags they
    test, their table rows; and the byte count."""
    h, w = (S, S) if isinstance(S, int) else S
    listed = torch.zeros((h // B) * (w // B), dtype=torch.bool)
    listed[blocks.cpu().long()] = True
    own = torch.nn.functional.pad(
        listed.view(h // B, w // B).repeat_interleave(B, 0)
        .repeat_interleave(B, 1), (1, 1, 1, 1))
    near = own.clone()
    for di, dj in ((0, 1), (1, 0), (0, -1), (-1, 0), (1, 1), (1, -1),
                   (-1, 1), (-1, -1)):
        near |= torch.roll(own, (di, dj), (0, 1))
    window = int(near.sum())
    nbytes = (window * (4 + 1 + 4) + int(own.sum()) * (4 + 4)
              + int(listed.sum()) * (4 + 4 + 9 * 4))
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def phase_subset_rounds(device, card):
    """11a: K1's ring and subset rounds in the TPU's order on 4096² ring
    windows of the 8192² cone, the shard shape of 11b's 2×2 mesh (a 64×64
    block grid at B = 64), from a mid-solve state: the centred window,
    whose ring is all neighbours, and 11b's top-left shard, whose ring is
    the canvas edge on two sides.  The interior and the frame rounds, in
    place one after the other (the split round's compute), dataflow ==
    plain bitwise, the ring untouched; then the interior, frame and full
    ring rounds timed beside their bounds.  Returns (times, max error)."""
    n, S, B = N_MESH, N_MESH // 2, 64
    elev = torch.from_numpy(make_cone(n)).to(device)
    W, base = weights_and_base(elev)
    K, W1 = compact_from_dense(W)
    del W, elev
    kw = dict(B=B, inner_max=2 * B + 4)
    nb = S // B
    x, _chg = gs_round_oriented(base, K, W1, base, 0, **kw)  # mid-solve
    worst = 0.0
    for where, (i0, j0), o in (("centred", (S // 2, S // 2), 1),
                               ("top-left shard", (0, 0), 2)):
        xw, Kw, W1w, bw = ring_window(x, K, W1, base, i0, j0, S)
        ring = torch.ones_like(xw, dtype=torch.bool)
        ring[1:-1, 1:-1] = False
        changed = []
        for subset in ("interior", "boundary"):
            err, xw, cd = oriented_vs_plain(
                "11a %s window, %s round" % (where, subset),
                (xw, Kw, W1w, bw), o, B, True, subset)
            worst = max(worst, err)
            changed.append(int(cd.sum()))
        check(torch.equal(xw[ring], ring_window(x, K, W1, base, i0, j0,
                                                S)[0][ring]),
              "11a %s window: the ring moved" % where)
        log("mesh", "11a the %s %d² window of the %d² cone, B=%d, "
            "orientation %d: the interior round (%d blocks) then the frame "
            "(%d blocks) on its output, dataflow == plain bitwise, ring "
            "untouched; blocks changed %s"
            % (where, S, n, B, o, (nb - 2) ** 2, 4 * (nb - 1), changed))
    del x
    xw, Kw, W1w, bw = ring_window(base, K, W1, base, S // 2, S // 2, S)
    del K, W1, base
    times = {}
    for subset in ("interior", "boundary", "all"):
        t = {}
        t["kernel"], reps = cuda_median_ms(
            lambda: gs_round_oriented(xw, Kw, W1w, bw, 0, ring=True,
                                      subset=subset, **kw), reps=5)
        log("time", "11a K1 %s round in the TPU's order, %d² window B=%d "
            "from the base, dataflow: median %.3f ms, reps %s [%s]"
            % (subset, S, B, t["kernel"], ["%.3f" % r for r in reps], card))
        blocks = (torch.arange(nb * nb) if subset == "all" else
                  torch.tensor(visit_sequence(nb, nb, 0, subset)))
        t["bound"], t["bytes"] = subset_bound(blocks, B, S)
        times[subset] = t
        log("time", "11a %s round: dataflow %.3f ms; bound %.4f ms by bytes "
            "(%.1f MB), %.1f%% of the dataflow round [%s]"
            % (subset, t["kernel"], t["bound"], t["bytes"] / 1e6,
               100 * t["bound"] / t["kernel"], card))
    log("time", "11a interior + frame %.3f ms against one full ring round "
        "%.3f ms, dataflow: ratio %.3f [%s]"
        % (times["interior"]["kernel"] + times["boundary"]["kernel"],
           times["all"]["kernel"], (times["interior"]["kernel"]
                                    + times["boundary"]["kernel"])
           / times["all"]["kernel"], card))
    return times, worst


def sync_all():
    for k in range(torch.cuda.device_count()):
        torch.cuda.synchronize(k)


def synced_seconds(fn):
    """``fn()`` and its host-clock seconds, every visible card
    synchronised before and after."""
    sync_all()
    t0 = time.perf_counter()
    out = fn()
    sync_all()
    return out, time.perf_counter() - t0


def canvas_equal(canvas, want):
    """A ShardedCanvas against a whole tensor, shard by shard (each shard's
    part of ``want`` copied to the shard's card): NaN patterns and values
    bitwise equal."""
    if tuple(canvas.shape) != tuple(want.shape):
        return False
    return all(tensors_equal(view, want[..., r0: r0 + h, c0: c0 + w]
                             .to(view.device))
               for view, (r0, c0, h, w) in canvas.views())


def tensors_equal(a, b):
    """Bitwise, NaN equal to NaN."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a), torch.nan_to_num(b))


def canvas_max_err(canvas, want):
    """The largest difference of a ShardedCanvas from a whole tensor, shard
    by shard (inf where the NaN patterns differ)."""
    return max(nan_equal_max_err(view, want[..., r0: r0 + h, c0: c0 + w]
                                 .to(view.device))
               for view, (r0, c0, h, w) in canvas.views())


def mesh_of(device, shape):
    return make_mesh([device] * (shape[0] * shape[1]), shape)


def check_near_step(tag, got, step, tol):
    """A mesh run (a dict of ShardedCanvases) against one device's
    ``terrain_step(blocked)``: mag, direction and flats bitwise, uca and
    twi within ``tol`` with equal NaN patterns.  Returns the largest
    difference of uca."""
    for key in ("mag", "direction", "flats"):
        check(canvas_equal(got[key], step[key]),
              "%s: %s differs from one device's terrain_step" % (tag, key))
    for key in ("uca", "twi"):
        for view, (r0, c0, h, w) in got[key].views():
            want = step[key][r0: r0 + h, c0: c0 + w].to(view.device)
            check(torch.equal(torch.isnan(view), torch.isnan(want))
                  and torch.allclose(torch.nan_to_num(view),
                                     torch.nan_to_num(want), **tol),
                  "%s: %s outside %s of one device's terrain_step"
                  % (tag, key, tol))
    return canvas_max_err(got["uca"], step["uca"])


def forced_solve(base, W, mesh, split, links=None, round_fn=None, B=None):
    """The sharded K1 solve of ``base``/``W`` (and pit links) with the
    split (True) or the serial (False) round forced, through the solver's
    private switch; ``round_fn``: the plain round in place of the kernel;
    ``B``: the block side, by default the canvas's (:func:`_block_size`).
    Returns (area as a ShardedCanvas, rounds)."""
    n_l, m_l = shard_dims(base.shape, mesh)
    area_s, rounds = sharded._blocked_shards(
        mesh_split(base, mesh), mesh_split(W, mesh), mesh,
        _block_size(*base.shape) if B is None else B,
        links=sharded._links_of(links, mesh, n_l, m_l, base.dtype),
        _force_split=split, _round_fn=round_fn)
    check(sharded._blocked_shards.last_split == split,
          "the solver did not take the forced round")
    return ShardedCanvas(area_s, mesh), rounds


def shards_equal(a, b):
    """Two ShardedCanvases of one layout, shard by shard, bitwise."""
    return all(torch.equal(x, y)
               for x, y in zip(a.local_shards(), b.local_shards()))


def mesh_kernel_vs_plain(tag, base, W, mesh, links=None, B=64):
    """The sharded solve through the dataflow launch against the same mesh
    through the plain rounds on the card, split and serial rounds forced:
    areas bitwise equal with equal rounds.  At B = 64 (default), where the
    1024² and 512² canvases' shards hold the 3x3 blocks a split round
    takes.  Returns the rounds by round kind."""
    rounds = {}
    for split in (True, False):
        reset_counts()
        got, rk = forced_solve(base, W, mesh, split, links, B=B)
        launches = launch_count(gs_round_oriented)
        want, rp = forced_solve(base, W, mesh, split, links,
                                gs_round_oriented_plain, B=B)
        check(rk == rp and shards_equal(got, want)
              and launches >= (2 if split else 1) * mesh.size * rk,
              "%s (split %s): the kernel's sharded solve != the plain one "
              "(rounds %d vs %d, %d launches)" % (tag, split, rk, rp,
                                                  launches))
        rounds["split" if split else "serial"] = rk
    log("mesh", "%s over a %dx%d mesh on one card: the dataflow launch == "
        "the plain rounds bitwise, equal rounds, split and serial: %s"
        % (tag, mesh.shape[0], mesh.shape[1], rounds))
    return rounds


def phase_sharded(device, card):
    """11b: the 8192² cone over four shards on the card against one
    device's terrain_step (the gate), split and serial rounds; the kernel
    against the plain rounds on a 2048² 2×2 mesh; 1×2 and 2×4 meshes at
    2048²; the one-card overlap.  Returns the main run's dataflow
    launches."""
    n = N_MESH
    elev = torch.from_numpy(make_cone(n)).to(device)
    args = spacing(n, torch.float32, device)
    step, step_s = synced_seconds(
        lambda: terrain_step(elev, *args, uca_solver="blocked"))
    log("mesh", "11b terrain_step(blocked) on one device, %d² cone: %.3f s, "
        "%d rounds in the TPU's order [%s]"
        % (n, step_s, step["uca_sweeps"], card))
    mesh = mesh_of(device, (2, 2))
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_counts()
    reads = counters["mesh_solve_reads"]
    out, split_s = synced_seconds(lambda: run_sharded(
        elev, *args, mesh=mesh, uca_solver="blocked"))
    launches = main_launches("11b run_sharded")
    reads = counters["mesh_solve_reads"] - reads
    peak = torch.cuda.max_memory_allocated() - held
    rounds = out["uca_sweeps"]
    check(sharded._blocked_shards.last_split and launches >= 2 * 4 * rounds,
          "11b: the 2x2 run did not take the split round in the TPU's "
          "order: %d dataflow launches for %d rounds" % (launches, rounds))
    err = check_near_step("11b 2x2 split", out, step, GATE_TOL["cone"])
    log("mesh", "11b run_sharded(blocked) over a 2x2 mesh of four %d² shards "
        "on %s, split round: %d rounds in the TPU's order (one device: %d); "
        "mag, direction, flats bitwise, uca and twi within %s of one "
        "device's terrain_step(blocked) (uca max abs %g); %.3f s "
        "(terrain_step %.3f s); %d dataflow launches (interior + frame), %d "
        "host reads of the change counts; peak device memory %.3f GB = %.1f "
        "planes of the canvas [%s]"
        % (n // 2, device, rounds, step["uca_sweeps"], GATE_TOL["cone"], err,
           split_s, step_s, launches, reads, peak / 1e9, peak / (n * n * 4.0),
           card))
    del out, step
    _mag, _dir, _flats, W, base = terrain_pre(elev, *args)
    del elev, _mag, _dir, _flats
    # the in-core solve alone, at the default B = 256 and at 64 (B = 16's
    # row was cut for the time limit)
    for B in (256, 64):
        solved = []
        ms, reps = cuda_median_ms(
            lambda: solved.append(accumulate_blocked_gs(base, W, B=B)))
        log("mesh", "11b accumulate_blocked_gs on the %d² cone's planes, "
            "B=%d: median %.3f ms, reps %s ms, %d rounds in the TPU's order "
            "[%s]" % (n, B, ms, ["%.3f" % t for t in reps], solved[-1][1],
                      card))
        del solved
    (a_split, r_split), split_solve_s = synced_seconds(
        lambda: forced_solve(base, W, mesh, True))
    (a_serial, r_serial), serial_s = synced_seconds(
        lambda: forced_solve(base, W, mesh, False))
    err = canvas_max_err(a_split, a_serial.assemble(device))
    check(r_split == rounds and torch.allclose(
        a_split.assemble(device), a_serial.assemble(device),
        **GATE_TOL["cone"]), "11b: the split and the serial solves differ "
        "beyond the gate (max %g; rounds %d, %d)" % (err, r_split, r_serial))
    log("mesh", "11b the solve alone on the same planes, both rounds forced: "
        "serial (exchange, then one ring round a shard) %.3f s, %d rounds; "
        "split %.3f s, %d rounds; areas max abs %g apart [%s]"
        % (serial_s, r_serial, split_solve_s, r_split, err, card))
    del a_split, a_serial
    ov = measure_halo_overlap(base, W, mesh)
    log("mesh", "11b overlap, %d² 2x2: exchange %.3f ms, relax %.3f ms, full "
        "(split %s) %.3f ms a round (%s, every block visited); overlap "
        "fraction %s (one card: the rings are copies on the card) [%s]"
        % (n, 1e3 * ov["t_exchange_per_round"],
           1e3 * ov["t_relax_per_round"], ov["split_round"],
           1e3 * ov["t_full_per_round"], ov["timer"],
           ov["overlap_fraction"], card))
    del W, base
    e = torch.from_numpy(make_cone(N_MAIN // 2)).to(device)
    a = spacing(N_MAIN // 2, torch.float32, device)
    _mg, _dr, _fl, W2, b2 = terrain_pre(e, *a)
    mesh_kernel_vs_plain("11b %d² cone" % (N_MAIN // 2), b2, W2,
                         mesh_of(device, (2, 2)))
    e = torch.from_numpy(make_cone(N_MAIN)).to(device)
    a = spacing(N_MAIN, torch.float32, device)
    _mg, _dr, _fl, W2, b2 = terrain_pre(e, *a)
    for shape in ((1, 2), (2, 4)):
        m = mesh_of(device, shape)
        got, got_s = synced_seconds(
            lambda: run_sharded(e, *a, mesh=m, uca_solver="blocked"))
        step = terrain_step(e, *a, uca_solver="blocked")
        err = check_near_step("11b %dx%d" % shape, got, step,
                              GATE_TOL["cone"])
        ov = measure_halo_overlap(b2, W2, m)
        log("mesh", "11b %d² cone over a %dx%d mesh (split %s): %d rounds; "
            "within %s of terrain_step (max abs %g, %d rounds); %.3f s; "
            "overlap: exchange %.3f ms, relax %.3f ms, full %.3f ms a round, "
            "fraction %s (one card, %s) [%s]"
            % (N_MAIN, shape[0], shape[1], sharded._blocked_shards.last_split,
               got["uca_sweeps"], GATE_TOL["cone"], err, step["uca_sweeps"],
               got_s, 1e3 * ov["t_exchange_per_round"],
               1e3 * ov["t_relax_per_round"], 1e3 * ov["t_full_per_round"],
               ov["overlap_fraction"], ov["timer"], card))
    return launches + phase_mesh_blocks(device, card)


# 11b's mesh at the JAX package's shard B = 32: a 2x2 mesh of 672² shards
# (21 blocks of 32 a side; 64 does not divide 672)
N_MESH32 = 1344


def phase_mesh_blocks(device, card):
    """11b at the shard block sizes the JAX mesh takes below 64:
    ``run_sharded(blocked)`` on the N_MESH32² cone over a 2x2 mesh on the
    card, whose shards take B = 32, within the gate of one device's
    ``terrain_step``, its dataflow launches all at 32; then the sharded
    solve at 32 (96² shards) and at 8 (40² shards) through the kernel
    against the same mesh through the plain rounds, split and serial.
    Returns the run's dataflow launches."""
    n = N_MESH32
    elev = torch.from_numpy(make_cone(n)).to(device)
    args = spacing(n, torch.float32, device)
    mesh = mesh_of(device, (2, 2))
    check(sharded._shard_block_size(n // 2, n // 2) == 32,
          "the %d² shards do not take B = 32" % (n // 2))
    reset_counts()
    out, secs = synced_seconds(lambda: run_sharded(
        elev, *args, mesh=mesh, uca_solver="blocked"))
    launches = main_launches("11b run_sharded at B=32")
    by = dict(gs_round_oriented.launches_by_block)
    rounds = out["uca_sweeps"]
    check(set(by) == {32} and launches >= 4 * rounds,
          "11b at B=32: the mesh's dataflow launches by block size %s for "
          "%d rounds" % (by, rounds))
    step = terrain_step(elev, *args, uca_solver="blocked")
    err = check_near_step("11b 2x2 at B=32", out, step, GATE_TOL["cone"])
    log("mesh", "11b run_sharded(blocked) on the %d² cone over a 2x2 mesh of "
        "%d² shards on one card at the shard B=32 (split %s): %d rounds "
        "(one device at B=%d: %d), within %s of terrain_step (uca max abs "
        "%g); %.3f s; %d dataflow launches [%s]"
        % (n, n // 2, sharded._blocked_shards.last_split, rounds,
           _block_size(n, n), step["uca_sweeps"], GATE_TOL["cone"], err,
           secs, launches, card))
    del out, step, elev
    for Bm, nm in ((32, 192), (8, 80)):
        e = torch.from_numpy(make_cone(nm)).to(device)
        _mg, _dr, _fl, W2, b2 = terrain_pre(e, *spacing(nm, torch.float32,
                                                        device))
        check(sharded._shard_block_size(nm // 2, nm // 2) == Bm,
              "the %d² shards do not take B = %d" % (nm // 2, Bm))
        mesh_kernel_vs_plain("11b %d² cone at the shard B=%d" % (nm, Bm),
                             b2, W2, mesh, B=Bm)
    return launches


def phase_sharded_pits(device, card, state):
    """11c: the hard chain's planes and pit links through sharded_uca on a
    2x2 mesh (which takes the split round), and with the serial round
    forced, against accumulate_blocked_pits_gs (one device, the TPU's
    order) within the hard gate; then the 512² hard chain's solve on a 2x2
    mesh, the kernel against the plain rounds, bitwise."""
    W, base, links = state
    gs, rgs = accumulate_blocked_pits_gs(base, W, *links)
    mesh = mesh_of(device, (2, 2))
    got, rg = sharded_uca(base, W, mesh, pit_links=links)
    check(sharded._blocked_shards.last_split, "11c: 2x2 did not split")
    res = {}
    for split, (got, rg) in ((True, (got, rg)),
                             (False, forced_solve(base, W, mesh, False,
                                                  links))):
        area = got.assemble(device)
        err = nan_equal_max_err(area, gs)
        check(torch.allclose(area, gs, **GATE_TOL["hard"]), "11c: the "
              "sharded pit solve (split %s) is outside %s of "
              "accumulate_blocked_pits_gs (max %g)"
              % (split, GATE_TOL["hard"], err))
        res["split" if split else "serial"] = (rg, err)
    log("mesh", "11c %d² hard terrain, %d pit links, 2x2 mesh: "
        "sharded_uca(pit_links=...) (rounds, max abs against one device) "
        "%s, within %s of accumulate_blocked_pits_gs in the TPU's order (%d "
        "rounds)" % (N_MAIN, len(links[0]), res, GATE_TOL["hard"], rgs))
    W, base, links = chain_state(make_hard_terrain(N_MAIN // 4), device)
    mesh_kernel_vs_plain("11c %d² hard chain, %d pit links"
                         % (N_MAIN // 4, len(links[0])), base, W, mesh, links)


def phase_mesh_manager(device, card, mesh=None, phase="11d"):
    """11d: ProcessManager(mesh=2x2 on the card, or ``mesh``) over the
    2048² cone's four tiles, process_twi and the GeoTIFF export, against
    the in-memory manager on the same tiles; then dryrun_multichip(4).
    Returns the mesh run's launches by kernel and card."""
    mesh = mesh_of(device, (2, 2)) if mesh is None else mesh
    work = tempfile.mkdtemp(prefix="pydem_smoke_mesh_")
    try:
        tiles = os.path.join(work, "tiles")
        cone = make_cone(N_MAIN)
        check(write_tiles(cone, tiles) == 4, "expected a 2x2 tile grid")
        runs = {}
        for tag, m in (("in-memory", None), ("mesh", mesh)):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                reset_counts()
                t0 = time.perf_counter()
                pm = ProcessManager(in_path=tiles, mesh=m,
                                    out_path=os.path.join(work, tag + ".zarr"),
                                    superblock=N_MAIN // 2)
                twi = pm.process_twi()
                for d in {d for d in mesh.devices.flat}:
                    torch.cuda.synchronize(d)
                run_s = time.perf_counter() - t0
                written, export_s = None, 0.0
                if m is not None:
                    t0 = time.perf_counter()
                    written = pm.save_non_overlap_data_geotiff(
                        os.path.join(work, "mesh_geotiff"))
                    export_s = time.perf_counter() - t0
            runs[tag] = (pm, twi, run_s, export_s,
                         main_launches("%s %s manager" % (phase, tag)),
                         counts_by_card())
            if written is not None:
                check_manager_exports(pm, pm.out_file, written)
        pm0, twi0, s0, _e0, _l0, _c0 = runs["in-memory"]
        pm1, twi1, s1, e1, l1, counts = runs["mesh"]
        check(pm1._ooc is not None and pm1._ooc.mesh is not None and l1 > 0,
              "%s: the mesh manager did not solve over the mesh (%d "
              "dataflow launches)" % (phase, l1))
        errs = {}
        for key in ("elev", "slope", "aspect", "uca", "twi"):
            errs[key], _bitwise = gate_equal(
                "%s %s" % (phase, key), pm1.out_file[key], pm0.out_file[key],
                GATE_TOL["cone"])
        log("mesh", "%s ProcessManager(mesh=%r) on the %d² cone's 4 tiles: "
            "process_twi %.1f s (in memory %.1f s), export %.1f s, stage "
            "seconds %s; elev, slope, aspect, uca, twi against the in-memory "
            "manager: NaN patterns equal, max abs %s within %s; %d "
            "dataflow launches, %d rounds [%s]"
            % (phase, mesh, N_MAIN, s1, s0, e1,
               {k: round(v, 3) for k, v in pm1.timer.report().items()},
               errs, GATE_TOL["cone"], l1, pm1._ooc.uca_rounds, card))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    res, dry_s = synced_seconds(lambda: dryrun_multichip(4))
    log("mesh", "%s dryrun_multichip(4), %d visible cards: %s, %.1f s"
        % (phase, torch.cuda.device_count(), res, dry_s))
    return counts


# -- phase 13: the deployment periphery -------------------------------------

N_DEPLOY = 2048  # a region's mosaic: 2x2 GeoTIFF tiles of ~1024²
DEPLOY_WORKERS = 2
N_SCALING = 4096  # mesh_scaling's cone
STARTUP_LINE = re.compile(r"\[worker (\S+)\] start-up on (\S+): (\{.*\})$")
JOB_LINE = re.compile(r"\[worker (\S+)\] job (\S+) done in ([0-9.]+) s, "
                      r"kernel launches (\{.*?\}): (\{.*\})$")


def deploy_regions(work, n):
    """Phase 9's hard terrain and the cone, each as 2x2 GeoTIFF tiles."""
    regions = {}
    for name, elev in (("hard", make_hard_terrain(n, "float32")),
                       ("cone", make_cone(n))):
        regions[name] = os.path.join(work, "regions", name)
        check(write_tiles(elev, regions[name]) == 4,
              "expected a 2x2 tile grid")
    return regions


def worker_lines(stdout):
    """The workers' start-up seconds, and each job's seconds, kernel
    launches and result, from their printed lines."""
    startups, jobs = [], {}
    for line in stdout.splitlines():
        m = STARTUP_LINE.search(line)
        if m:
            startups.append((m.group(1), m.group(2), json.loads(m.group(3))))
        m = JOB_LINE.search(line)
        if m:
            jobs[m.group(2)] = {"worker": m.group(1),
                                "seconds": float(m.group(3)),
                                "launches": json.loads(m.group(4)),
                                "result": json.loads(m.group(5))}
    return startups, jobs


def deploy_job(tiles, out_path, export, device):
    """A job's work in this process, as the worker runs it."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "pits had no place to drain"
        pm = ProcessManager(in_path=tiles, out_path=out_path, resume=True,
                            dem_proc_kwargs=MANAGER_KW, device=device)
        pm.process_twi()
        pm.save_non_overlap_data_geotiff(export)
    return pm


def check_same_job(what, store_path, export, want_store, want_export):
    """A job's store ``uca``/``twi`` and its five GeoTIFFs bitwise equal to
    another run's."""
    got, want = ArrayStore(store_path), ArrayStore(want_store)
    for key in ("uca", "twi"):
        a, b = got[key], want[key]
        check(a.dtype == b.dtype and a.shape == b.shape
              and a.tobytes() == b.tobytes(),
              "%s: store %s differs (max abs %g)" % (
                  what, key, float(np.nanmax(np.abs(a - b)))))
    for key in EXPORT_KEYS:
        with open(os.path.join(export, key + ".tif"), "rb") as f, \
                open(os.path.join(want_export, key + ".tif"), "rb") as g:
            check(f.read() == g.read(), "%s: %s.tif differs" % (what, key))


def phase_deploy(device, card, chain):
    """Phase 13: the cloud-burst queue, submit and worker on the card, the
    golden check, the examples and the two measuring tools."""
    work = tempfile.mkdtemp(prefix="pydem_deploy_")
    try:
        return _phase_deploy(device, card, chain, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _phase_deploy(device, card, chain, work, n=N_DEPLOY):
    dev_arg = "cuda" if device.type == "cuda" else "cpu"
    env = dict(os.environ, PYTHONPATH=ROOT)
    regions = deploy_regions(work, n)

    # 13a: submit enqueues the regions, two workers drain them
    queue = os.path.join(work, "queue")
    exports = os.path.join(work, "exports")
    t0 = time.perf_counter()
    sub = subprocess.run(
        [sys.executable, "-m", "pydem_tpu_torch.deploy.submit", "--queue",
         queue, *regions.values(), "--local-workers", str(DEPLOY_WORKERS),
         "--device", dev_arg, "--export-root", exports, "--dem-proc-kwargs",
         json.dumps(MANAGER_KW)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    check(sub.returncode == 0, "submit exited with %d: %s%s" % (
        sub.returncode, sub.stdout[-3000:], sub.stderr[-3000:]))
    names = {k: job_name(r) for k, r in regions.items()}
    st = jobqueue.status(queue)
    check(sorted(st["done"]) == sorted(names.values()) and not st["failed"]
          and not st["pending"] and not st["claimed"],
          "queue after submit: %s" % st)
    startups, jobs = worker_lines(sub.stdout)
    check(len(startups) == DEPLOY_WORKERS and sorted(jobs)
          == sorted(names.values()), "workers printed %d start-ups and jobs "
          "%s" % (len(startups), sorted(jobs)))
    log("deploy", "13a submit --local-workers %d --device %s: %d regions of "
        "2x2 tiles (%d² mosaics: hard terrain, cone) done, none failed, "
        "%.1f s wall [%s]" % (DEPLOY_WORKERS, dev_arg, len(regions), n,
                              wall, card))
    for wid, wdev, secs in startups:
        log("deploy", "13a worker %s on %s start-up: %s s [%s]" % (
            wid, wdev, {k: round(v, 3) for k, v in secs.items()}, card))
    for key, name in names.items():
        job = jobs[name]
        check(job["result"]["canvas_shape"] == [n, n]
              and job["result"]["n_tiles"] == 4, "job %s: %s" % (name, job))
        # (on the CPU the wrappers run their plain versions and count none)
        check(job["launches"]["uca_gs_round_dataflow"] > 0
              or device.type == "cpu",
              "job %s launched no K1 round: %s" % (name, job))
        log("deploy", "13a job %s (%s): %.3f s, %.4g px/s, %d rounds, "
            "kernel launches %s [%s]" % (
                name, key, job["seconds"], n * n / job["seconds"],
                job["result"]["uca_rounds"], job["launches"], card))

    reset_counts()
    for key, name in names.items():
        deploy_job(regions[key], os.path.join(work, name + ".zarr"),
                   os.path.join(work, name + "_tif"), device)
    launches = counts_by_card()
    check(launch_count(gs_round_oriented) > 0 or device.type == "cpu",
          "13a: the in-process runs launched no K1 round")
    for key, name in names.items():
        check_same_job("13a job %s" % name,
                       os.path.join(regions[key], "results.zarr"),
                       os.path.join(exports, name),
                       os.path.join(work, name + ".zarr"),
                       os.path.join(work, name + "_tif"))
    log("deploy", "13a each job's store uca/twi and five GeoTIFFs bitwise "
        "equal to an in-process ProcessManager run of the same tiles on %s; "
        "K1 launches in those runs %s"
        % (device, launches["uca_gs_round_dataflow"]))

    # 13b: a job preempted after its elevation stage, stolen and finished
    queue2 = os.path.join(work, "queue_preempt")
    spec = {"in_path": regions["hard"], "out_of_core": False,
            "out_path": os.path.join(work, "preempt.zarr"),
            "export": os.path.join(work, "preempt_tif"),
            "dem_proc_kwargs": MANAGER_KW}
    check(jobqueue.submit(queue2, "preempted", spec), "13b: submit")
    name, spec, claim = jobqueue.claim_next(queue2)
    reset_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pm = ProcessManager(in_path=spec["in_path"],
                            out_path=spec["out_path"], resume=True,
                            dem_proc_kwargs=spec["dem_proc_kwargs"],
                            device=device)
        pm.compute_grid()
        pm._success_init()
        pm._stage_guarded("elevation", pm.process_elevation)
    for kernel, by_card in counts_by_card().items():
        for d, c in by_card.items():
            launches[kernel][d] = launches[kernel].get(d, 0) + c
    check("elev" in pm.out_file and "uca" not in pm.out_file,
          "13b: the claimed job's store holds %s"
          % sorted(os.listdir(spec["out_path"])))
    del pm
    if device.type == "cuda":
        torch.cuda.empty_cache()
    old = time.time() - 1e4
    os.utime(claim, (old, old))  # the lease expires
    t0 = time.perf_counter()
    steal = subprocess.run(
        [sys.executable, "-m", "pydem_tpu_torch.deploy.worker", "--queue",
         queue2, "--drain", "--device", dev_arg],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    steal_s = time.perf_counter() - t0
    check(steal.returncode == 0, "13b: the worker exited with %d: %s" % (
        steal.returncode, steal.stderr[-3000:]))
    check(jobqueue.status(queue2)["done"] == [name], "13b: queue %s"
          % jobqueue.status(queue2))
    _s, stolen = worker_lines(steal.stdout)
    check_same_job("13b preempted job", spec["out_path"], spec["export"],
                   os.path.join(regions["hard"], "results.zarr"),
                   os.path.join(exports, names["hard"]))
    log("deploy", "13b a job claimed here, preempted after its elevation "
        "stage and stolen after its lease: the worker resumed it (%.3f s "
        "of job, %.1f s with start-up; kernel launches %s), store and "
        "GeoTIFFs bitwise equal to 13a's uninterrupted job [%s]"
        % (stolen[name]["seconds"], steal_s, stolen[name]["launches"], card))

    # 13c: the golden check on this device
    failed, figures = golden_check.check(dev_arg)
    check(not failed, "13c: golden check failed on %s: %s" % (failed,
                                                            figures))
    log("deploy", "13c golden_check --device %s passed: %s [%s]" % (
        dev_arg, {k: "NaN masks %s, rel p99 %.3e, max %.3e%s" % (
            "equal" if f["nan_match"] else "DIFFER", f["p99"], f["max"],
            ", bitwise" if f["bitwise"] else "")
            for k, f in figures.items()}, card))

    # 13d: the examples and the two measuring tools
    arrays = process_array.main(["--device", dev_arg])
    check(all(np.isfinite(a).any() and a.shape == (256, 256)
              for a in arrays.values()), "13d: process_array's outputs")
    tiles = fixtures.mk_test_multifile(33, 64, os.path.join(work, "demo"),
                                       nx_grid=2, ny_grid=2, nx_overlap=2,
                                       ny_overlap=2)
    _pm, written = process_manager_directory.main([tiles, "--device",
                                                   dev_arg])
    check(sorted(os.path.basename(f) for f in written)
          == sorted(k + ".tif" for k in EXPORT_KEYS),
          "13d: process_manager_directory wrote %s" % written)
    log("deploy", "13d both examples ran on %s" % device)
    hb = hard_breakdown.main(["--n", str(n), "--reps", str(BREAKDOWN_REPS),
                              "--device", dev_arg])
    ratio = hb["ratio"]["median"]
    check(abs(ratio - 1) <= BREAKDOWN_TOL,
          "13d: hard_breakdown's stage sum is %.3f x its uncut chain (median "
          "of reps %s)" % (ratio, ["%.3f" % r for r in hb["ratio"]["reps"]]))
    log("deploy", "13d hard_breakdown %d²: stage sum median %.3f ms, uncut "
        "chain median %.3f ms, sum / uncut rep by rep %s, median %.3f; "
        "phase 8's uncut chain %.3f ms, its median ratio %.3f [%s]" % (
            n, hb["sum"]["median"], hb["chain"]["median"],
            ["%.3f" % r for r in hb["ratio"]["reps"]], ratio,
            chain["chain"]["median"], chain["ratio"]["median"], card))
    sc = mesh_scaling.scaling(N_SCALING, dev_arg)
    cone = torch.as_tensor(mesh_scaling.cone(N_SCALING), device=device)
    gs = terrain_step(cone, *spacing(N_SCALING, cone.dtype, device),
                      uca_solver="blocked")["uca_sweeps"]
    rounds = [r["rounds"] for r in sc["rows"]]
    check(sc["rows"][0]["shape"] == [1, 1] and min(rounds) >= 1,
          "13d: mesh_scaling's rows %s" % sc["rows"])
    log("deploy", "13d mesh_scaling %d²: %d shapes (%s), rounds %s in the "
        "TPU's order, each shape's own (one device's terrain_step %d: the "
        "in-core solver threads a frontier, the mesh's rounds none) [%s]"
        % (N_SCALING, len(rounds), [r["mesh"] for r in sc["rows"]], rounds,
           gs, card))
    return launches


# -- phase 12: the mesh over four cards (--multicard) ------------------------

N_CARDS = 4
N_MULTI = 16384  # 12b, 12c: four 8192² shards, one a card
N_WIDE = 24576   # 12e: a canvas one card's budget refuses, four cards hold
WIDE_FREE_BYTES = 40 << 30  # room 12e's two stores need, with slack
KEYS = ("mag", "direction", "flats", "uca", "twi")


def phase_cards():
    """12: fail unless four cards are visible; print them, their topology
    and which pairs reach each other's memory.  Returns the cards and the
    tag printed beside every number ("name, power limit" of each)."""
    count = torch.cuda.device_count()
    check(count >= N_CARDS, "--multicard needs %d visible cards, found %d"
          % (N_CARDS, count))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=index,name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    for line in smi:
        log("cards", line.strip())
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True, timeout=60)
    for line in topo.stdout.rstrip().splitlines():
        log("cards", "topo: " + line.rstrip())
    cards = [torch.device("cuda", k) for k in range(N_CARDS)]
    peer = [[int(i == j or torch.cuda.can_device_access_peer(i, j))
             for j in range(N_CARDS)] for i in range(N_CARDS)]
    log("cards", "can_device_access_peer (row reads column): %s" % peer)
    names = [", ".join(p.strip() for p in line.split(",")[1:])
             for line in smi[:N_CARDS]]
    tag = ("%d x %s" % (N_CARDS, names[0]) if len(set(names)) == 1
           else "; ".join("cuda:%d %s" % kv for kv in enumerate(names)))
    return cards, tag


def cone_window(n, rows, cols, device, ring=0):
    """The pixels (rows × cols, index tensors) of an n² cone (float32),
    computed in float64 on the card, element by element: every window
    equals the same pixels of the whole canvas bit for bit, on whichever
    card.  ``ring``: that many pixels at the cone's edges are NaN."""
    rows, cols = rows.to(device), cols.to(device)
    step = 2.0 / (n - 1)
    x = rows.double() * step - 1
    y = cols.double() * step - 1
    r = torch.sqrt(x[:, None] * x[:, None] + y[None, :] * y[None, :])
    root2 = torch.tensor(np.sqrt(2.0), dtype=torch.float64, device=device)
    out = (1.05 - r / root2).float()
    if ring:
        out[(rows < ring) | (rows >= n - ring), :] = float("nan")
        out[:, (cols < ring) | (cols >= n - ring)] = float("nan")
    return out


def cone_rows(n, r0, r1, device):
    """Rows r0..r1 of an n² cone (float32), bitwise those rows of the
    whole canvas on any card (:func:`cone_window`)."""
    return cone_window(n, torch.arange(r0, r1), torch.arange(n), device)


CONE_BAND = 4096  # rows of a shard built at a time (float64 temporaries)


def cone_canvas(n, mesh, copies=1, ring=0):
    """A (copies·n)² canvas of copies × copies n² cones (each with ``ring``
    px of NaN at its edges) over ``mesh``, built shard by shard on each
    shard's card in bands of rows: no device holds more than its own
    shards, and every pixel equals the same pixel of one cone on any
    card.  A ShardedCanvas."""
    N = copies * n
    shards = []
    for dev, (r0, c0, h, w) in pieces(mesh, (N, N)):
        t = torch.empty((h, w), dtype=torch.float32, device=dev)
        cols = torch.arange(c0, c0 + w) % n
        for a in range(0, h, CONE_BAND):
            b = min(h, a + CONE_BAND)
            t[a:b] = cone_window(n, torch.arange(r0 + a, r0 + b) % n, cols,
                                 dev, ring)
        shards.append(t)
    return ShardedCanvas(shards, mesh)


DIGEST_ROWS = 1024  # rows a digest chunk; divides every shard height hashed


def chunk_digests(canvas):
    """sha256 of each DIGEST_ROWS-row chunk of a canvas (its NaN mask, then
    its values with NaN as 0), keyed by the chunk's first row: of a whole
    tensor, or of the local shards of a ShardedCanvas (which must cover
    whole rows), a chunk at a time through the host, so no card gathers
    another's rows.  The same canvas gives the same chunks in any
    layout."""
    n, m = canvas.shape[-2:]
    if isinstance(canvas, ShardedCanvas):
        bands = {}
        for view, (r0, c0, h, w) in canvas.views():
            bands.setdefault((r0, h), []).append((c0, view))
    else:
        bands = {(0, n): [(0, canvas)]}
    out = {}
    for (r0, h), parts in sorted(bands.items()):
        parts.sort(key=lambda p: p[0])
        check(sum(v.shape[-1] for _c, v in parts) == m
              and r0 % DIGEST_ROWS == 0
              and (h % DIGEST_ROWS == 0 or r0 + h == n),
              "chunk digests need bands of whole chunks and rows")
        for a in range(0, h, DIGEST_ROWS):
            chunk = np.concatenate([v[a: a + DIGEST_ROWS].cpu().numpy()
                                    for _c, v in parts], axis=-1)
            d = hashlib.sha256()
            if chunk.dtype.kind == "f":
                d.update(np.isnan(chunk).tobytes())
                chunk = np.nan_to_num(chunk)
            d.update(chunk.tobytes())
            out[r0 + a] = d.hexdigest()
    return out


def combine_digests(chunks):
    """One sha256 over the chunk digests in row order."""
    d = hashlib.sha256()
    for r in sorted(chunks):
        d.update(chunks[r].encode())
    return d.hexdigest()


def digests(out):
    """Each output's digest (:func:`chunk_digests` combined): the same for a
    whole tensor on one card and for its shards over the cards."""
    return {key: combine_digests(chunk_digests(out[key])) for key in KEYS}


def phase_card_rounds(cards, tag):
    """12a: on every card, a K2 round against its plain version, bit for
    bit, and K1 in the TPU's order at the shapes the four-card path gives
    it: the canvas round on a 2048² cone; the ring round and the interior
    and frame rounds on windows of a mid-solve state of the 16384² cone at
    every shard shape of 12b-12e, the dataflow launch == the plain version
    (on the first card at the shapes past 2048², where the plain round
    takes seconds, and up to 8192²; elsewhere the dataflow launch twice,
    bit for bit), timed at 12b's shard and 12c's band; the ring round at
    12g's shard (:func:`giant_shard_rounds`).  Returns {kernel: {card:
    times}} and the largest difference."""
    times = {k: {} for k in ("oriented", "oriented_b256", "k2", "ring",
                             "subset", "band", "giant")}
    worst = 0.0
    for k, dev in enumerate(cards):
        with torch.cuda.device(dev):
            t, err = _card_rounds(dev, tag, plain_large=k == 0)
        worst = max(worst, err)
        for key, v in t.items():
            times[key][str(dev)] = v
    return times, worst


def ring_round_checked(what, args, B, subset, plain):
    """A ring round in the TPU's order at orientation 0, every block dirty,
    through the dataflow launch: with ``plain`` against the plain version,
    else against a second dataflow launch, bitwise.  Returns the largest
    difference."""
    if plain:
        return oriented_vs_plain(what, args, 0, B, True, subset)[0]
    kw = dict(B=B, inner_max=2 * B + 4, ring=True, subset=subset)
    d = gs_round_oriented(*args, 0, **kw)
    again = gs_round_oriented(*args, 0, **kw)
    torch.cuda.synchronize()
    e = nan_equal_max_err(d[0], again[0])
    check(e <= KERNEL_TOL and torch.equal(d[1], again[1]),
          "%s: two dataflow launches differ (max err %g)" % (what, e))
    return e


def _card_rounds(dev, tag, plain_large=True):
    times, worst = {}, 0.0
    n, B = N_MAIN, 64
    kw = dict(B=B, inner_max=2 * B + 4)
    W, base = weights_and_base(cone_rows(n, 0, n, dev))
    K, W1 = compact_from_dense(W)
    ones = torch.ones((n // B,) * 2, dtype=torch.int32, device=dev)
    bound = round_bound([base, K, W1, base, ones], [base, ones], W)
    t, err = time_round("12a K1 round in the TPU's order, %d² on %s"
                        % (n, dev),
                        (("kernel", gs_round_oriented),
                         ("plain", gs_round_oriented_plain)),
                        ((base, K, W1, base, 0), kw), tag, plain_reps=1)
    worst = max(worst, err)
    t["bound"], t["bound_by"] = bound
    times["oriented"] = t
    # the main path's default block side: a cluster of 16 CTAs a block
    kw256 = dict(B=256, inner_max=2 * 256 + 4)
    t, err = time_round("12a K1 round in the TPU's order B=256, %d² on %s"
                        % (n, dev),
                        (("kernel", gs_round_oriented),
                         ("plain", gs_round_oriented_plain)),
                        ((base, K, W1, base, 0), kw256), tag, plain_reps=1)
    worst = max(worst, err)
    t["bound"], t["bound_by"] = bound
    times["oriented_b256"] = t
    Wc = W.contiguous()
    t, err = time_round("12a K2 round, %d² on %s" % (n, dev),
                        (("kernel", block_round), ("plain", block_round_plain)),
                        ((base, Wc, base), kw), tag)
    worst = max(worst, err)
    t["bound"], t["bound_by"] = round_bound([base, Wc, base], [base, ones], W)
    times["k2"] = t
    del W, Wc, K, W1, base, ones

    # the ring and subset rounds at the shapes the four-card path gives
    # them, windows of a mid-solve state of the 16384² cone
    n = N_MULTI
    W, base = weights_and_base(cone_rows(n, 0, n, dev))
    K, W1 = compact_from_dense(W)
    del W
    x, _f = gs_round_oriented(base, K, W1, base, 0, **kw)

    def window(i0, j0, h, w):
        return ring_window(x, K, W1, base, i0, j0, h, w)

    def timed(what, args, subset):
        t = {}
        t["kernel"], _reps = cuda_median_ms(
            lambda: gs_round_oriented(*args, 0, ring=True, subset=subset,
                                      **kw), reps=5)
        h, w = args[3].shape
        t["bound"], t["bytes"] = subset_bound(
            torch.arange((h // B) * (w // B)) if subset == "all" else
            torch.tensor(visit_sequence(h // B, w // B, 0, subset)), B,
            (h, w))
        log("time", "12a K1 %s round in the TPU's order, %s on %s: dataflow "
            "%.3f ms; bound %.4f ms [%s]"
            % (subset, what, dev, t["kernel"], t["bound"], tag))
        return t

    S = n // 2
    shapes = (  # (what, (i0, j0, h, w), the subset forms too)
        ("12b's %d² shard" % S, (0, 0, S, S), True),
        ("12c's %dx%d band" % (n // 4, n), (0, 0, n // 4, n), False),
        ("12e's %d² shard" % (N_WIDE // 2), (0, 0, N_WIDE // 2, N_WIDE // 2),
         False),
        ("12e's %d² shard on one card" % (N_OOC // 2),
         (N_OOC // 2, N_OOC // 2, N_OOC // 2, N_OOC // 2), True),
        ("12d's %d² shard" % (N_MAIN // 2), (S, S, N_MAIN // 2, N_MAIN // 2),
         True))
    for what, (i0, j0, h, w), subsets in shapes:
        args = window(i0, j0, h, w)
        plain = plain_large or h <= N_MAIN
        for subset in ("all",) + (("interior", "boundary") if subsets
                                  else ()):
            worst = max(worst, ring_round_checked(
                "12a %s %s round on %s" % (what, subset, dev), args, B,
                subset, plain and h * w <= N_MULTI * N_MULTI // 4))
        del args
    log("cards", "12a %s: the round in the TPU's order and K2 (2048²) kernel "
        "== plain bitwise; on windows of a mid-solve state of the %d² cone, "
        "the ring rounds at %s and the interior and frame rounds at %s in "
        "the TPU's order: dataflow == plain bitwise at the shapes up to "
        "8192² (%s), elsewhere two dataflow launches bitwise"
        % (dev, n, [w for w, _s, _f in shapes],
           [w for w, _s, f in shapes if f],
           "all of them" if plain_large else "this card: up to 2048²"))
    # the times: 12b's shard (the ring round is the four-card solver's,
    # interior + frame the forced split's), 12c's band
    rnd = {}
    args = window(0, 0, S, S)
    for subset in ("all", "interior", "boundary"):
        rnd[subset] = timed(shapes[0][0], args, subset)
    args = window(0, 0, n // 4, n)
    times["band"] = timed(shapes[1][0], args, "all")
    del args
    times["ring"] = rnd["all"]
    times["subset"] = {k: rnd["interior"][k] + rnd["boundary"][k]
                       for k in ("kernel", "bound")}
    times["subset"].update(interior=rnd["interior"]["kernel"],
                           boundary=rnd["boundary"]["kernel"])
    del x, K, W1, base
    times["giant"], e = giant_shard_rounds(dev, tag, B)
    return times, max(worst, e)


def tile_window(t, period, rows, cols, total, fill):
    """Rows ``rows`` and columns ``cols`` (ranges, which may reach one
    past the edges) of the total² canvas that tiles the period² plane
    ``t``; ``fill`` beyond the canvas."""
    r = torch.arange(rows.start, rows.stop, device=t.device)
    c = torch.arange(cols.start, cols.stop, device=t.device)
    out = t.index_select(0, r % period).index_select(1, c % period)
    out[(r < 0) | (r >= total)] = fill
    out[:, (c < 0) | (c >= total)] = fill
    return out


def giant_shard_rounds(dev, tag, B):
    """12a at 12g's shard: the ring round in the TPU's order on the
    top-left 24576² shard of 12g's canvas (3x3 copies of the 16384² cone,
    each ringed with NaN), two dataflow launches bit for bit (the plain
    round there would need the shard's dense planes, 19 GB); the dataflow
    launch timed.  The planes are a mid-solve state:
    one ringed cone's compact state after two rounds, tiled.  The NaN rings
    keep the copies apart and every spacing is 1, so these are the planes
    of the whole canvas, cut as :func:`ring_window` cuts them, built
    without the canvas's dense weights.  Returns (times, max error)."""
    n, N = GIANT_CONE, GIANT_COPIES * GIANT_CONE
    S = N // 2
    kw = dict(B=B, inner_max=2 * B + 4)
    W, base = weights_and_base(cone_window(n, torch.arange(n),
                                           torch.arange(n), dev, ring=1))
    K, W1 = compact_from_dense(W)
    del W
    x = base
    for o in range(2):
        x, _f = gs_round_oriented(x, K, W1, base, o, **kw)
    ringed = range(-1, S + 1)
    planes = (torch.nan_to_num(tile_window(x, n, ringed, ringed, N, 0.0)),
              tile_window(K, n, ringed, ringed, N, 255),
              tile_window(W1, n, ringed, ringed, N, 0.0),
              tile_window(base, n, range(S), range(S), N, 0.0))
    del x, K, W1, base
    worst = ring_round_checked("12a ring round at 12g's %d² shard on %s"
                               % (S, dev), planes, B, "all", False)
    ms, reps = cuda_median_ms(
        lambda: gs_round_oriented(*planes, 0, ring=True, **kw), reps=5)
    bound, nbytes = subset_bound(torch.arange((S // B) ** 2), B, S)
    log("time", "12a K1 ring round in the TPU's order at 12g's %d² shard (a "
        "mid-solve state of the 3x3 ringed copies of the %d² cone) on %s: "
        "two launches bitwise; the dataflow launch: median %.3f ms, "
        "reps %s ms; bound %.3f ms (%d bytes) [%s]"
        % (S, n, dev, ms, ["%.3f" % t for t in reps], bound, nbytes, tag))
    return {"kernel": ms, "bound": bound}, worst


def card_peaks(cards):
    return {str(d): torch.cuda.max_memory_allocated(d) for d in cards}


def reset_peaks(cards):
    gc.collect()
    for d in cards:
        torch.cuda.synchronize(d)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(d)


def fmt_reps(reps):
    return "median %.3f s, reps %s s" % (statistics.median(reps),
                                         ["%.3f" % r for r in reps])


def same_area(a, b):
    """Two ShardedCanvases of one shard layout, on any cards: bitwise,
    shard by shard."""
    return all(torch.equal(x, y.to(x.device))
               for x, y in zip(a.local_shards(), b.local_shards()))


def phase_cards_sharded(cards, tag):
    """12b: run_sharded(blocked) on the 16384² cone over a 2x2 mesh of the
    four cards (the serial round, one ring round a shard in the TPU's
    order) against one card's terrain_step(blocked) within the cone gate,
    in turns; the solve alone with the split and the serial round forced
    over the four cards, each bitwise equal to the same forced round over
    four shards on one card, equal rounds; times, each card's peak memory,
    the overlap; then run_sharded over a (4, 1) mesh of the four cards,
    12c's reference.  Returns the (4, 1) run's digests and rounds, the
    2x2 run's launches and the solve times."""
    n, dev0 = N_MULTI, cards[0]
    args = spacing(n, torch.float32, dev0)
    mesh = make_mesh(cards, (2, 2))
    log("cards", "12b mesh %r: shard (iy, ix) -> %s" % (mesh, {
        c: str(mesh.devices[c]) for c in mesh.local_shards()}))
    one_reps, four_reps = [], []
    for rep in range(3):  # in turns: one card, four cards
        # the one card's canvas whole on it; the four cards' built shard by
        # shard on each card, as a user of four cards hands it over
        elev = cone_rows(n, 0, n, dev0)
        reset_peaks(cards)
        step, t = synced_seconds(lambda: terrain_step(
            elev, *args, uca_solver="blocked"))
        one_reps.append(t)
        if rep == 0:
            one_peak = card_peaks(cards)[str(dev0)]
            step_rounds = step["uca_sweeps"]
            # kept on the host for the check: the four cards' peaks below
            # must not count it on cuda:0
            step = {k: v.cpu() for k, v in step.items()
                    if isinstance(v, torch.Tensor)}
        else:
            del step
        del elev
        elev4 = cone_canvas(n, mesh)
        reset_peaks(cards)
        reset_counts()
        reads = counters["mesh_solve_reads"]
        out, t = synced_seconds(lambda: run_sharded(
            elev4, *args, mesh=mesh, uca_solver="blocked"))
        four_reps.append(t)
        if rep == 0:
            launches = counts_by_card()
            main_launches("12b run_sharded over the four cards")
            reads = counters["mesh_solve_reads"] - reads
            peaks = card_peaks(cards)
            split = sharded._blocked_shards.last_split
            rounds = out["uca_sweeps"]
            check(all(s.device == mesh.devices[c] for key in KEYS
                      for c, s in zip(mesh.local_shards(),
                                      out[key].local_shards())),
                  "12b: an output shard is not on its cell's card")
            gate_err = check_near_step("12b four cards", out, step,
                                       GATE_TOL["cone"])
            del step
        del out, elev4
    nb = (n // 2 // _block_size(n, n),) * 2
    used = launches["uca_gs_round_dataflow"]
    check(split == sharded._use_split(mesh, nb) is False
          and all(used.get(str(d), 0) >= rounds for d in cards),
          "12b: the run did not take the serial round in the TPU's order on "
          "every card: %s" % launches)
    log("cards", "12b run_sharded(blocked), %d² cone over 2x2 = four %d² "
        "shards on %s, the serial round: %d rounds in the TPU's order; mag, "
        "direction, flats bitwise, uca and twi within %s of one card's "
        "terrain_step(blocked) (uca max abs %g, %d rounds); launches by "
        "kernel and card %s; %d host reads [%s]"
        % (n, n // 2, [str(d) for d in cards], rounds, GATE_TOL["cone"],
           gate_err, step_rounds, launches, reads, tag))
    log("cards", "12b wall: one card's terrain_step %s; four cards %s (host "
        "clock, every card synchronised) [%s]"
        % (fmt_reps(one_reps), fmt_reps(four_reps), tag))
    log("cards", "12b peak device memory: one card's terrain_step %.3f GB = "
        "%.1f planes of the canvas; the four-card run by card %s GB (a "
        "shard is %.3f GB a plane; input and outputs stay on their shards) "
        "[%s]" % (one_peak / 1e9, one_peak / (n * n * 4.0),
                  {k: round(v / 1e9, 3) for k, v in peaks.items()},
                  n * n / 4 * 4 / 1e9, tag))
    others = max(peaks[str(d)] for d in cards[1:])
    check(peaks[str(dev0)] <= 1.10 * others, "12b: %s peaked at %.3f GB, "
          "over 110%% of the other cards' largest, %.3f GB"
          % (dev0, peaks[str(dev0)] / 1e9, others / 1e9))
    elev = cone_rows(n, 0, n, dev0)
    _mag, _dir, _flats, W, base = terrain_pre(elev, *args)
    del elev, _mag, _dir, _flats
    solves = {True: [], False: []}
    areas, solve_rounds = {}, {}
    for rep in range(3):  # in turns
        for split_ in ((True, False) if rep % 2 == 0 else (False, True)):
            (a, r), t = synced_seconds(
                lambda: forced_solve(base, W, mesh, split_))
            solves[split_].append(t)
            if rep == 0:
                areas[split_], solve_rounds[split_] = a, r
            del a
    check(solve_rounds[False] == rounds, "12b: the forced serial solve took "
          "%d rounds, run_sharded %d" % (solve_rounds[False], rounds))
    one_card = mesh_of(dev0, (2, 2))
    for split_ in (True, False):
        a, r = forced_solve(base, W, one_card, split_)
        check(r == solve_rounds[split_] and same_area(areas[split_], a),
              "12b: the four cards' %s solve != four shards on %s (rounds "
              "%d vs %d)" % ("split" if split_ else "serial", dev0,
                             solve_rounds[split_], r))
        del a
    err = canvas_max_err(areas[True], areas[False].assemble(dev0))
    del areas
    log("cards", "12b the solve alone on the same planes over the four "
        "cards, both rounds forced, each bitwise equal to the same round "
        "over four shards on %s with equal rounds: split %s, %d rounds; "
        "serial %s, %d rounds; split and serial max abs %g apart [%s]"
        % (dev0, fmt_reps(solves[True]), solve_rounds[True],
           fmt_reps(solves[False]), solve_rounds[False], err, tag))
    ov = measure_halo_overlap(base, W, mesh)
    log("cards", "12b overlap over four cards, %d² 2x2: exchange %.3f ms, "
        "relax %.3f ms, full (split %s) %.3f ms a round (%s, every block "
        "visited, best of 3); overlap fraction %s [%s]"
        % (n, 1e3 * ov["t_exchange_per_round"],
           1e3 * ov["t_relax_per_round"], ov["split_round"],
           1e3 * ov["t_full_per_round"], ov["timer"], ov["overlap_fraction"],
           tag))
    del W, base
    bands = make_mesh(cards, (4, 1))
    elev4 = cone_canvas(n, bands)
    out, bands_s = synced_seconds(lambda: run_sharded(
        elev4, *args, mesh=bands, uca_solver="blocked"))
    want, want_rounds = digests(out), out["uca_sweeps"]
    log("cards", "12b run_sharded(blocked) over a (4, 1) mesh of the four "
        "cards in one process (12c's reference): %d rounds, %.3f s [%s]"
        % (want_rounds, bands_s, tag))
    del out, elev4
    return want, want_rounds, launches, dict(
        split=split, solve_split=statistics.median(solves[True]),
        solve_serial=statistics.median(solves[False]), overlap=ov)


def _nccl_rank(rank, world, url, n, work):
    """One rank of 12c: its row band of the cone on its card, run_global
    over NCCL; writes its counts and times, rank 0 the digests."""
    import torch.distributed as dist

    from pydem_tpu_torch.parallel import multihost

    multihost.initialize(url, world, rank, backend="nccl")
    dev = torch.device("cuda", torch.cuda.current_device())
    band = n // world
    rows = cone_rows(n, rank * band, (rank + 1) * band, dev)
    ones = np.ones(n)
    res = dict(rank=rank, device=str(dev), walls=[])
    for rep in range(2):
        reset_counts()
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        dist.barrier()
        t0 = time.perf_counter()
        out = multihost.run_global(rows, ones[1:], ones[1:], ones, ones,
                                   uca_solver="blocked")
        torch.cuda.synchronize(dev)
        res["walls"].append(time.perf_counter() - t0)
        if rep == 0:
            res.update(rounds=out["uca_sweeps"], counts=counts_by_card(),
                       dataflow=launch_count(gs_round_oriented),
                       peak=torch.cuda.max_memory_allocated(dev),
                       shards=len(out["uca"].local_shards()))
            # after the timing: this rank hashes its own band; then every
            # rank joins one gather, which rank 0 hashes
            res["chunks"] = {k: chunk_digests(out[k]) for k in KEYS}
            whole = out["uca"].assemble()
            if rank == 0:
                res["gathered_uca"] = combine_digests(chunk_digests(whole))
            del whole
        del out
    with open(os.path.join(work, "rank%d.json" % rank), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


NCCL_TIMEOUT_S = 300
NCCL_PEAK_BYTES = 8.5e9  # a rank holds its band's planes, not the canvas


def phase_cards_nccl(cards, tag, want, want_rounds):
    """12c: four processes, one NCCL rank a card, run_global(blocked) on
    the 16384² cone in (4, 1) row bands: bitwise equal to one process
    running the same (4, 1) mesh of the four cards (12b's digests), rounds
    equal.  Returns each rank's launches by kernel and card."""
    import socket

    import torch.multiprocessing as mp

    work = tempfile.mkdtemp(prefix="pydem_smoke_nccl_")
    try:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            url = "tcp://127.0.0.1:%d" % sock.getsockname()[1]
        gc.collect()
        for d in cards:
            torch.cuda.synchronize(d)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ctx = mp.start_processes(_nccl_rank, args=(N_CARDS, url, N_MULTI,
                                                   work),
                                 nprocs=N_CARDS, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + NCCL_TIMEOUT_S
        try:
            while not ctx.join(timeout=5):
                check(time.monotonic() < deadline, "12c: the ranks did not "
                      "end within %d s" % NCCL_TIMEOUT_S)
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(10)
        spawn_s = time.perf_counter() - t0
        ranks = []
        for r in range(N_CARDS):
            with open(os.path.join(work, "rank%d.json" % r)) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    bands = {key: combine_digests({int(r): d for rk in ranks
                                   for r, d in rk["chunks"][key].items()})
             for key in KEYS}
    check(bands == want and ranks[0]["gathered_uca"] == want["uca"]
          and all(r["shards"] == 1 for r in ranks),
          "12c: NCCL ranks differ from one process over the four cards")
    check(all(r["rounds"] == want_rounds for r in ranks),
          "12c: rounds %s, one process %d" % ([r["rounds"] for r in ranks],
                                              want_rounds))
    check(sorted(r["device"] for r in ranks) == [str(d) for d in cards]
          and all(r["dataflow"] > 0 for r in ranks),
          "12c: not one rank a card, or no dataflow launches: %s" % ranks)
    peaks = [r["peak"] for r in ranks]
    check(max(peaks) < NCCL_PEAK_BYTES, "12c: a rank peaked at %.3f GB"
          % (max(peaks) / 1e9))
    log("cards", "12c four NCCL ranks (spawned, one a card: %s), "
        "run_global(blocked) on the %d² cone in (4, 1) row bands, each "
        "output left on its rank as its band: mag, direction, flats, uca, "
        "twi, hashed band by band on the ranks, bitwise equal to one "
        "process over the same (4, 1) mesh of the four cards (sha256), the "
        "uca gathered after the timing too; %d rounds; wall by rank (host "
        "clock, first run with the communicators' set-up, then a second) %s "
        "s; dataflow launches by rank %s; peak device memory by rank %s GB; "
        "the whole "
        "phase %.1f s with process start [%s]"
        % ([r["device"] for r in ranks], N_MULTI, want_rounds,
           [["%.3f" % w for w in r["walls"]] for r in ranks],
           [r["dataflow"] for r in ranks],
           [round(r["peak"] / 1e9, 3) for r in ranks], spawn_s, tag))
    return [r["counts"] for r in ranks]


def phase_cards_pits(cards, tag):
    """12d: the hard terrain's planes and pit links (2048², chain_state)
    through sharded_uca over the four cards (the serial round), against
    the same forced round over four shards on one card, bitwise with equal
    rounds, and against one card's accumulate_blocked_pits_gs within the
    hard gate.  Returns the solver's run's launches by kernel and card."""
    dev0 = cards[0]
    W, base, links = chain_state(make_hard_terrain(N_MAIN), dev0)
    gs, rgs = accumulate_blocked_pits_gs(base, W, *links)
    mesh = make_mesh(cards, (2, 2))
    reset_counts()
    got, rg = sharded_uca(base, W, mesh, pit_links=links)
    launches = counts_by_card()
    split = sharded._blocked_shards.last_split
    want, rw = forced_solve(base, W, mesh_of(dev0, (2, 2)), split, links)
    check(rg == rw and same_area(got, want), "12d: four cards differ from "
          "four shards on one card (split %s; rounds %d vs %d)"
          % (split, rg, rw))
    area = got.assemble(dev0)
    err = nan_equal_max_err(area, gs)
    check(torch.allclose(area, gs, **GATE_TOL["hard"]), "12d: outside %s "
          "of one card's accumulate_blocked_pits_gs (max %g)"
          % (GATE_TOL["hard"], err))
    used = launches["uca_gs_round_dataflow"]
    check(all(used.get(str(d), 0) > 0 for d in cards),
          "12d: the run did not take the dataflow launch on every card: %s"
          % launches)
    log("cards", "12d %d² hard terrain, %d pit links, 2x2 over the four "
        "cards: sharded_uca(pit_links=...) (split %s) bitwise equal to the "
        "same round over four shards on %s, %d rounds both; within %s of "
        "one card's accumulate_blocked_pits_gs (max abs %g, %d rounds); "
        "launches by kernel and card %s"
        % (N_MAIN, len(links[0]), split, dev0, rw, GATE_TOL["hard"], err,
           rgs, launches))
    return launches


def phase_cards_engine(cards, tag):
    """12e: the out-of-core engine with its canvases per shard on each
    shard's card.  8192²: a 2x2 mesh over the four cards == a 2x2 mesh on
    cuda:0, fused both, bitwise, the one card's solve held to the four
    cards' serial round (the split round is another order).  24576²: the fit test refuses one card's
    budget and takes the four cards'; the fused pass over the four cards,
    each card's peak under its budget, uca/twi within the cone gate of
    run_sharded on the same canvas over the same cards.  Returns the
    launches by kernel and card of each four-card run."""
    work = tempfile.mkdtemp(prefix="pydem_smoke_cards_ooc_")
    launches = []
    try:
        free = shutil.disk_usage(work).free
        check(free >= WIDE_FREE_BYTES, "12e needs %.0f GB free in %s, has "
              "%.1f GB" % (WIDE_FREE_BYTES / 1e9, work, free / 1e9))
        n, S = N_OOC, S_OOC
        elev = cone_rows(n, 0, n, cards[0]).cpu().numpy()
        runs = {}
        use_split = sharded._use_split
        for where, mesh in (("one card", mesh_of(cards[0], (2, 2))),
                            ("four cards", make_mesh(cards, (2, 2)))):
            if where == "one card":  # the four cards' round kind
                sharded._use_split = lambda mesh, nb, force=None: False
            try:
                store, eng, res = ooc_run(work, where.replace(" ", "_"),
                                          elev, S, None, mesh=mesh,
                                          **OOC_OPTS)
            finally:
                sharded._use_split = use_split
            check(res["fused"] and res["launches"] > 0
                  and res["ring_launches"] == 0
                  and not sharded._blocked_shards.last_split,
                  "12e %d² %s: not the fused per-shard pass: %s"
                  % (n, where, res))
            runs[where] = (store, eng, res)
            log("cards", "12e %d² S=%d, 2x2 mesh on %s: fused, total %.3f s, "
                "stage seconds %s, %d rounds, peak by card %s GB, dataflow "
                "launches by card %s [%s]"
                % (n, S, where, res["total"],
                   {k: round(v, 3) for k, v in res["stages"].items()},
                   res["rounds"], {str(k): round(v / 1e9, 3)
                                   for k, v in res["peak_on"].items()},
                   {str(k): v for k, v in res["on"].items()}, tag))
        launches.append(runs["four cards"][2]["counts"])
        (s1, e1, r1), (s4, e4, r4) = runs["one card"], runs["four cards"]
        for key in ("slope", "aspect", "flats", "uca", "twi"):
            a, b = s1[key], s4[key]
            check(a.shape == (n, n) and a.dtype == b.dtype
                  and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"),
                  "12e %d²: %s over four cards != over one card" % (n, key))
        check(r1["rounds"] == r4["rounds"], "12e: rounds differ")
        log("cards", "12e %d²: slope, aspect, flats, uca, twi of the engine "
            "over four cards bitwise equal to the engine over four shards "
            "on %s (the serial round both), %d rounds both"
            % (n, cards[0], r4["rounds"]))
        del runs, s1, s4, e1, e4, elev
        shutil.rmtree(os.path.join(work, "one_card.zarr"))
        shutil.rmtree(os.path.join(work, "four_cards.zarr"))
        launches.append(_wide_engine(cards, tag, work)["counts"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches


def _wide_engine(cards, tag, work):
    n, S = N_WIDE, S_OOC
    mesh = make_mesh(cards, (2, 2))
    budget = min(outofcore._default_device_cache(d) for d in cards)
    one = outofcore.fits_device_resident((n, n), 4, budget)
    four = outofcore.fits_device_resident((n, n), 4, budget, mesh)
    log("cards", "12e %d²: fits_device_resident with a card's budget of "
        "%.1f GB: mesh=None %s (needs %.1f GB), 2x2 over four cards %s "
        "(%.1f GB a card) [%s]"
        % (n, budget / 1e9, one,
           outofcore._DEVICE_RESIDENT_PLANES * n * n * 4 / 1e9, four,
           outofcore._DEVICE_RESIDENT_PLANES * n * n * 4 / 4 / 1e9, tag))
    check(not one and four, "12e: the fit test at %d² is not (False, True)"
          % n)
    elev = cone_rows(n, 0, n, cards[0])
    store, eng, res = ooc_run(work, "wide", elev, S, None, mesh=mesh,
                              **OOC_OPTS)
    check(res["fused"] and res["launches"] > 0 and res["ring_launches"] == 0,
          "12e %d²: the engine did not take the fused per-shard pass" % n)
    for d, peak in res["peak_on"].items():
        check(peak <= eng.device_cache_bytes, "12e: %s peaked at %.1f GB, "
              "over its %.1f GB budget" % (d, peak / 1e9,
                                            eng.device_cache_bytes / 1e9))
    ooc_report("12e fused over four cards", n, S, res, tag)
    log("cards", "12e %d² S=%d over the four cards: fused, %d rounds, peak "
        "by card %s GB against a budget of %.1f GB a card, dataflow launches "
        "by card %s [%s]"
        % (n, S, res["rounds"],
           {str(k): round(v / 1e9, 3) for k, v in res["peak_on"].items()},
           eng.device_cache_bytes / 1e9,
           {str(k): v for k, v in res["on"].items()}, tag))
    store_gb = sum(os.path.getsize(os.path.join(dp, f))
                   for dp, _dn, fs in os.walk(store.root) for f in fs) / 1e9
    del eng, elev
    gc.collect()
    elev4 = cone_canvas(n, mesh)
    reset_peaks(cards)
    ref, ref_s = synced_seconds(lambda: run_sharded(
        elev4, *spacing(n, torch.float32, cards[0]), mesh=mesh,
        uca_solver="blocked"))
    del elev4
    errs = {}
    for key in ("uca", "twi"):  # shard by shard against the store
        tol = GATE_TOL["cone"]
        worst = 0.0
        for view, (i0, j0, h, w) in ref[key].views():
            a = store.read_window(key, (i0, i0 + h), (j0, j0 + w))
            b = view.cpu().numpy()
            check(np.array_equal(np.isnan(a), np.isnan(b)),
                  "12e %s: NaN patterns differ in the shard at (%d, %d)"
                  % (key, i0, j0))
            fa, fb = np.nan_to_num(a), np.nan_to_num(b)
            check(np.all(np.abs(fa - fb) <= tol["atol"]
                         + tol["rtol"] * np.abs(fb)),
                  "12e %s outside the cone gate in the shard at (%d, %d)"
                  % (key, i0, j0))
            worst = max(worst, float(np.abs(fa - fb).max()))
            del a, b, fa, fb
        errs[key] = worst
    log("cards", "12e %d²: engine uca, twi against run_sharded(blocked) on "
        "the same canvas over the same cards (%.3f s, %d rounds), shard by "
        "shard: NaN patterns equal, max abs %s within %s; the store %.1f GB "
        "on disk [%s]" % (n, ref_s, ref["uca_sweeps"], errs,
                          GATE_TOL["cone"], store_gb, tag))
    del ref
    return res


# 12g: 3x3 copies of 12b's cone, a 49152² canvas in four 24576² shards
GIANT_COPIES = 3
GIANT_CONE = N_MULTI
GIANT_BUDGET_S = 300  # more reps only while the phase stays inside this
GIANT_ALLOC = "expandable_segments:True"


def phase_cards_giant(cards, tag):
    """12g: a canvas the assembling path could not hold on cuda:0.
    GIANT_COPIES² copies of 12b's n² cone, each with its outer 1-px ring
    NaN (so no flow crosses between copies), over a 2x2 mesh of the four
    cards, built shard by shard on each card; the copies straddle the
    shard edges.  run_sharded(blocked) on it; every copy's five planes,
    gathered one copy at a time, against one card's terrain_step(blocked)
    on one ringed copy: mag, direction and flats bitwise (NaN equal), uca
    and twi within the cone gate (each copy is cut by the shard edges at
    other places, and a shard runs its own sequential grid).
    Wall time (median of 3 if the phase's budget allows, else fewer, said
    so), rounds of both, each card's peak.  Returns the first run's launches by
    kernel and card.

    A 24576² shard asks for 18 GiB blocks (its eight weight planes) after
    the label flood has freed its int64 tables: the default allocator
    found 20.8 GiB free on a card but no block that long.  So the phase
    turns on the allocator's expandable segments, which map such a block
    into one range, after the earlier phases' cached blocks are released;
    an out-of-memory error fails it."""
    reset_peaks(cards)  # empties every card's cache
    with warnings.catch_warnings():  # deprecated in later releases
        warnings.simplefilter("ignore", FutureWarning)
        torch.cuda.memory._set_allocator_settings(GIANT_ALLOC)
    t_phase = time.perf_counter()
    n = GIANT_CONE
    dev0, N = cards[0], GIANT_COPIES * n
    mesh = make_mesh(cards, (2, 2))
    elev = cone_window(n, torch.arange(n), torch.arange(n), dev0, ring=1)
    single, one_s = synced_seconds(lambda: terrain_step(
        elev, *spacing(n, torch.float32, dev0), uca_solver="blocked"))
    ref = {k: single[k].cpu() for k in KEYS}  # kept on the host
    one_rounds = single["uca_sweeps"]
    del elev, single
    args = spacing(N, torch.float32, dev0)
    walls, peaks, launches, rounds = [], None, None, None
    for rep in range(3):
        elev = cone_canvas(n, mesh, GIANT_COPIES, ring=1)
        reset_peaks(cards)
        reset_counts()
        out, t = synced_seconds(lambda: run_sharded(
            elev, *args, mesh=mesh, uca_solver="blocked"))
        walls.append(t)
        del elev
        if rep == 0:
            launches, peaks = counts_by_card(), card_peaks(cards)
            rounds, split = out["uca_sweeps"], sharded._blocked_shards.last_split
            expandable = collections.Counter(
                "cuda:%d" % seg["device"]
                for seg in torch.cuda.memory_snapshot()
                if seg.get("is_expandable"))
            _giant_check(out, ref, mesh, n)
        check(out["uca_sweeps"] == rounds, "12g: rounds differ between reps")
        del out
        gc.collect()
        spent = time.perf_counter() - t_phase
        if spent + 1.5 * max(walls) > GIANT_BUDGET_S:
            break
    used = launches["uca_gs_round_dataflow"]
    check(all(used.get(str(d), 0) > 0 for d in cards),
          "12g: the run did not take the dataflow launch on every card: %s"
          % launches)
    log("cards", "12g %d² float32 = %dx%d copies of the %d² cone, each "
        "ringed with NaN, over 2x2 = four %d² shards on %s, built shard by "
        "shard on each card: run_sharded(blocked) %d rounds; one card's "
        "terrain_step on one ringed copy %d rounds (%.3f s); every copy's "
        "mag, direction, flats bitwise equal to it (NaN equal), uca and twi "
        "within the cone gate, gathered a copy at a time [%s]"
        % (N, GIANT_COPIES, GIANT_COPIES, n, N // 2,
           [str(d) for d in cards], rounds, one_rounds, one_s, tag))
    log("cards", "12g wall (host clock, every card synchronised): %s of "
        "%d run%s%s; peak device memory by card %s GB (a shard is %.3f GB "
        "a plane; allocator %s, expandable segments by card %s); launches "
        "by kernel and card %s [%s]"
        % (fmt_reps(walls), len(walls), "s" if len(walls) > 1 else "",
           "" if len(walls) == 3 else " (the phase's %d s budget allowed "
           "no more)" % GIANT_BUDGET_S,
           {k: round(v / 1e9, 3) for k, v in peaks.items()},
           (N // 2) ** 2 * 4 / 1e9, GIANT_ALLOC, dict(expandable), launches, tag))
    return launches


def _giant_check(out, ref, mesh, n):
    """Each copy of ``out`` (gathered onto the card of its top-left shard,
    one copy's plane at a time) against the one-copy planes ``ref``."""
    half = out["uca"].shape[-1] // 2
    for key in KEYS:
        on = {}
        for i in range(GIANT_COPIES):
            for j in range(GIANT_COPIES):
                dev = mesh.devices[(i * n) // half, (j * n) // half]
                if dev not in on:
                    on[dev] = ref[key].to(dev)
                got = out[key].window((i * n, (i + 1) * n),
                                      (j * n, (j + 1) * n), device=dev)
                want = on[dev]
                ok = tensors_equal(got, want) if key in (
                    "mag", "direction", "flats") else (
                    torch.equal(torch.isnan(got), torch.isnan(want))
                    and torch.allclose(torch.nan_to_num(got),
                                       torch.nan_to_num(want),
                                       **GATE_TOL["cone"]))
                check(ok, "12g: copy (%d, %d) %s differs from one card's "
                      "ringed copy" % (i, j, key))
                del want
                del got
        del on


def main_multicard():
    """Phases 1, 2 and 12 (``--multicard``): the mesh over four cards."""
    card = phase_device()
    cards, tag = phase_cards()
    t0 = time.perf_counter()
    phase_build()
    rounds_ms, err = phase_card_rounds(cards, tag)
    want, want_rounds, l12b, split = phase_cards_sharded(cards, tag)
    l12c = phase_cards_nccl(cards, tag, want, want_rounds)
    l12d = phase_cards_pits(cards, tag)
    l12e = phase_cards_engine(cards, tag)
    l12f = phase_mesh_manager(cards[0], tag, make_mesh(cards, (2, 2)), "12f")
    l12g = phase_cards_giant(cards, tag)
    log("done", "phases 1, 2 and 12 passed in %.1f s" % (
        time.perf_counter() - t0))
    # the launches of the main-path runs of 12b-12g, by kernel and card
    on = {name: collections.Counter() for name, _fn in WRAPPERS}
    for part in [l12b, *l12c, l12d, *l12e, l12f, l12g]:
        for name, by_card in part.items():
            on[name].update(by_card)
    for d in cards:
        check(on["uca_gs_round_dataflow"][str(d)] > 0,
              "no K1 launch on %s on the four-card path" % d)
    log("cards", "launches of the runs of 12b-12g by kernel and card: %s"
        % {k: dict(v) for k, v in on.items()})
    src = "pydem_tpu_torch/ops/csrc/uca_block.cu"

    def entry(name, kind, replaces, launches, plain="plain"):
        per = rounds_ms[kind]
        med = {k: statistics.median(t[k] for t in per.values())
               for k in ("kernel", plain, "bound")}
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": med["kernel"],
                "plain_ms": med[plain], "bound_ms": med["bound"],
                "bound_by": next(iter(per.values())).get("bound_by", "bytes"),
                "library_ms": None,
                "ms_by_card": {k: t["kernel"] for k, t in per.items()},
                "launches_by_card": dict(on.get(name, {}))}

    # the dataflow launch: one round in the TPU's order from the base on
    # 2048² (canvas form, beside its plain version); the ring form at 12b's
    # shard, 12c's band and 12g's shard, the interior + frame at 12b's shard
    dataflow = entry("uca_gs_round_dataflow", "oriented", REPLACES_K1,
                     sum(on["uca_gs_round_dataflow"].values()))
    for key, kind in (("shard_ring", "ring"), ("band", "band"),
                      ("split", "subset")):
        dataflow.update({"%s_%s" % (key, k): statistics.median(
            t[k] for t in rounds_ms[kind].values())
            for k in ("kernel", "bound")})
    dataflow.update({"giant_shard_" + k: statistics.median(
        t[k] for t in rounds_ms["giant"].values()) for k in ("kernel",
                                                             "bound")})
    # the main path's default B = 256, a cluster of 16 CTAs a block (the
    # entry's own figures are B = 64's)
    dataflow.update({"b256_%s" % k: statistics.median(
        t[k] for t in rounds_ms["oriented_b256"].values())
        for k in ("kernel", "plain")})
    dataflow["launches_by_block"] = dict(MAIN_BY_BLOCK)
    print(json.dumps({"kernels": [
        dataflow,
        entry("uca_block_round", "k2", "pydem_tpu/ops/uca_block.py:42",
              sum(on["uca_block_round"].values())),
    ], "split_round_over_cards": split["split"]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


REPLACES_K1 = ("pydem_tpu/ops/uca_block.py:256 (_gs_kernel; the grid order "
               "of gs_round_oriented :444, _FLIPS :184, _subset_grid :242, "
               "subset branches :279-303)")


def block_figures(t):
    """K1 in the TPU's order at one block side, phase 8's figures at 2048²
    (:func:`time_oriented_rounds`), for the kernels line."""
    return {
        "cluster_ctas": t["cluster"],
        "ms_by_orientation": t["ms_by_orientation"],
        "skipped_ms": t["skipped_ms"],
        "skipped_bound_ms": t["skipped_bound"],
        "partial_ms": t["partial_ms"],
        "partial_bound_ms": t["partial_bound"],
        "partial_dirty_share": t["partial_share"],
        "critical_path_ms": t["critical_path_ms"],
        "cone_solve_ms": t["solve_ms"],
        "cone_solve_rounds": t["solve_rounds"],
        "cone_solve_bound_ms": t["solve_bound"],
        "hard_pit_solve_ms": t["pit_solve_ms"],
        "hard_pit_solve_rounds": t["pit_solve_rounds"],
        "hard_pit_solve_bound_ms": t["pit_solve_bound"],
    }


def dataflow_entries(launches, err, k1, ring_ms, subset_ms):
    """The kernels-line entries of K1 in the TPU's order, the dataflow
    launch: one round at 2048² from the base (every block visited),
    orientation 0, at the main path's B = 256 (a cluster of 16 CTAs a
    block), and one entry each for B = 128 (clusters of 4) and 64 (one
    CTA)."""
    by = k1["by_block"]
    main_b = _block_size(N_MAIN, N_MAIN)
    entries = []
    for B in (main_b,) + tuple(b for b in TIMED_BLOCKS if b != main_b):
        t = by[B]
        entry = {
            "name": "uca_gs_round_dataflow" + ("" if B == main_b
                                               else "_b%d" % B),
            "route": "cuda",
            "source": "pydem_tpu_torch/ops/csrc/uca_block.cu",
            "replaces": REPLACES_K1,
            "launches": (launches if B == main_b
                         else MAIN_BY_BLOCK.get(B, 0)),
            "max_abs_err": err,
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"],
            "bound_by": t["bound_by"],
            "library_ms": None,  # no PyTorch call computes a relaxation round
            "block": B,
            "role": ("every K1 round of the main paths at their default B "
                     "(canvas, ring and subset forms in the TPU's order, one "
                     "launch a round)" if B == main_b else
                     "K1 in the TPU's order at B=%d (B= and block_size= "
                     "take it)" % B),
            "sweep_ms": k1["sweep_ms"][B],
        }
        if B in k1["sweep_probe"]:
            # ms a sweep of each cluster visit (the shipped one "async")
            entry["sweep_probe_ms"] = k1["sweep_probe"][B]
        entry.update(block_figures(t))
        if B == main_b:
            entry["launches_by_block"] = dict(MAIN_BY_BLOCK)
        if B == 64:
            entry.update({
                # the ring form on a 2048² window (10a) and the subset
                # forms on a 4096² shard (11a), from the base
                "ring_window_ms": ring_ms["kernel"],
                "ring_window_bound_ms": ring_ms["bound"],
                "interior_ms": subset_ms["interior"]["kernel"],
                "boundary_ms": subset_ms["boundary"]["kernel"],
                "shard_ring_ms": subset_ms["all"]["kernel"],
                "shard_ring_bound_ms": subset_ms["all"]["bound"]})
        entries.append(entry)
    for B in MESH_BLOCKS:
        t = k1["mesh_blocks"][B]
        entries.append({
            "name": "uca_gs_round_dataflow_b%d" % B,
            "route": "cuda",
            "source": "pydem_tpu_torch/ops/csrc/uca_block.cu",
            "replaces": REPLACES_K1,
            "launches": MAIN_BY_BLOCK.get(B, 0),
            "max_abs_err": err,
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"],
            "bound_by": t["bound_by"],
            "library_ms": None,
            "block": B,
            "role": "K1 in the TPU's order at the mesh's B=%d (shards that "
                    "%d divides and %d does not, as the JAX mesh picks)"
                    % (B, B, 2 * B),
        })
    return entries


# -- phase 14: the facet sweep kernel ----------------------------------------

N_FACETS = 6000  # the benchmark's tile: a MERIT Hydro 5°x5° tile at 3"


def phase_facets(device, card, n=N_FACETS):
    """The facet sweep kernel (``ops.facets.facet_sweep``) against the
    eager sweep on an n² float32 tile, bit for bit, and both timed (median
    of 5 after a warm-up) beside the byte bound."""
    elev = torch.from_numpy(make_noisy_cone(n) * 600).to(device)
    rows = torch.arange(n - 1, dtype=torch.float64)
    dX = (92.6 * torch.cos(torch.deg2rad(40.0 + rows * 5.0 / n))).float()
    dX = dX.to(device)
    dY = torch.full((n - 1,), 92.6, dtype=torch.float32, device=device)
    got = facet_sweep(elev, dX, dY)
    want = _slopes_directions_eager(elev, dX, dY)
    err = 0.0
    for name, a, b in zip(("mag", "direction"), got, want):
        diff = int((a.view(torch.int32) != b.view(torch.int32)).sum())
        check(diff == 0, "facet sweep: %s differs from the eager sweep at %d "
              "pixels" % (name, diff))
        err = max(err, nan_equal_max_err(a, b))
    del got, want
    ms, reps = cuda_median_ms(lambda: facet_sweep(elev, dX, dY), reps=5)
    plain_ms, plain_reps = cuda_median_ms(
        lambda: _slopes_directions_eager(elev, dX, dY), reps=5)
    # elevation read once, mag and direction written once
    bound_ms = 12 * n * n / HBM_BYTES_PER_S * 1e3
    log("facets", "%d² float32 on %s: kernel %.4f ms (reps %s), eager %.2f "
        "ms (reps %s), bound %.4f ms: %.1f%% of the bound, %.1fx the eager "
        "sweep" % (n, card, ms, ["%.4f" % r for r in reps], plain_ms,
                   ["%.2f" % r for r in plain_reps], bound_ms,
                   100 * bound_ms / ms, plain_ms / ms))
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, err=err)


# -- phase 15: the union-find flood kernel ------------------------------------

N_FLOOD = 6000  # the benchmark's tile


def benchmark_flat_mask(cell, device, n=N_FLOOD):
    """The flat mask (``mag == -1``) of the benchmark cell's surface at
    n²: the coast's sea is one 18 Mpx flat, the filled basin has almost
    none."""
    from hydrobench.terrain.fractal import generator, surface

    with open(os.path.join(ROOT, "hydrobench", "traffic",
                           "%s.json" % cell)) as f:
        traffic = json.load(f)
    gen = generator(traffic["terrain"]["surface_seed"], device)
    z, sea = surface(traffic, (n, n), gen, device)
    z = torch.where(sea, float("nan"), z)
    d = torch.full((n - 1,), 92.6, dtype=z.dtype, device=device)
    mag, _direction = facet_sweep(z, d, d)
    return mag == -1


def phase_flood(device, card, n=N_FLOOD):
    """The flood kernel (``ops.flood.flood_labels`` through
    ``label_flood``) against the eager loop on the flat masks of both
    benchmark cells at n², labels and ``rep`` bit for bit, and both timed
    (median of 5 after a warm-up) beside the byte bound."""
    out = {}
    for cell in ("merit-coast", "merit-basin"):
        mask = benchmark_flat_mask(cell, device, n)
        payload = torch.rand((n, n), device=device)
        before = counters["flood_kernel"], counters["flood_launches"]
        lbl, rep = label_flood(mask, payload)
        calls = counters["flood_kernel"] - before[0]
        launches = counters["flood_launches"] - before[1]
        check((calls, launches) == (1, 3), "flood: %d calls, %d launches"
              % (calls, launches))
        iters = counters["flood_iters"]
        want_lbl, want_rep = _label_flood_eager(mask, payload)
        iters = counters["flood_iters"] - iters
        diff = int((lbl != want_lbl).sum())
        check(diff == 0, "flood %s: labels differ from the eager loop's at "
              "%d pixels" % (cell, diff))
        check(torch.equal(rep.view(torch.int32), want_rep.view(torch.int32)),
              "flood %s: rep differs from the eager loop's" % cell)
        del lbl, rep, want_lbl, want_rep
        ms, reps = cuda_median_ms(lambda: flood_labels(mask), reps=5)
        plain_ms, plain_reps = cuda_median_ms(
            lambda: _label_flood_eager(mask, payload), reps=5)
        # the mask read once (1 B), the labels written once (4 B)
        bound_ms = 5 * n * n / HBM_BYTES_PER_S * 1e3
        log("flood", "%s %d² on %s: %d flat px, kernel %.4f ms (reps %s, %d "
            "launches a call), eager %.2f ms (reps %s, %d sweeps), bound "
            "%.4f ms: %.1f%% of the bound, %.1fx the eager loop" % (
                cell, n, card, int(mask.sum()), ms,
                ["%.4f" % r for r in reps], launches, plain_ms,
                ["%.2f" % r for r in plain_reps], iters, bound_ms,
                100 * bound_ms / ms, plain_ms / ms))
        out[cell] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         launches=launches)
    return out


def main():
    card = phase_device()
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    last = [t0]

    def clock(phase):
        """The seconds of the phase that just ended, and since the start."""
        now = time.perf_counter()
        log("clock", "%s: %.1f s (%.1f s since the start)"
            % (phase, now - last[0], now - t0))
        last[0] = now

    phase_build()
    clock("2 build")
    k1_err, k2_err = 0.0, 0.0
    for n in (N_CHECK, N_FORMS, N_MAIN):
        # every B at 512²; 1024² for the clusters' subset rounds (at 512²,
        # B = 256 is 2x2); at 2048², where a plain round at B = 16 or less
        # takes seconds, the main paths' 256 and the 128 and 64 beside it
        e1, e2 = phase_kernel_vs_plain(device, n, phase3_blocks(n))
        k1_err, k2_err = max(k1_err, e1), max(k2_err, e2)
        if n == N_FORMS:
            repeats_bitwise(device, n)
        clock("3 kernels vs plain at %d²" % n)
    k1_launches = phase_main_path(device)
    k1_launches += phase_hard_chain(device)
    clock("4-5 main paths")
    k2_launches, e2, e1, state = phase_k2_path(device)
    k1_err, k2_err = max(k1_err, e1), max(k2_err, e2)
    phase_f64_chain(device)
    clock("6-7 K2 path, float64 chain")
    k2_ms, e2, chain, k1 = phase_times(device, card, state)
    k1_err = max(k1_err, *(t["err"] for t in k1["by_block"].values()),
                 *(t["err"] for t in k1["mesh_blocks"].values()))
    k2_err = max(k2_err, e2)
    clock("8 times")
    k1_launches += phase_manager(device, card)
    clock("9 manager")
    ring_ms, ring_err = phase_ring_round(device, card, k1["by_block"][64])
    k1_launches += phase_ooc_scale(device, card)
    k1_launches += phase_ooc_hard(device, card)
    phase_ooc_precision(device)
    clock("10 out of core")
    subset_ms, subset_err = phase_subset_rounds(device, card)
    k1_launches += phase_sharded(device, card)
    phase_sharded_pits(device, card, state)
    del state
    counts = phase_mesh_manager(device, card)
    k1_launches += sum(counts["uca_gs_round_dataflow"].values())
    clock("11 mesh")
    deploy = phase_deploy(device, card, chain)
    k1_launches += sum(deploy["uca_gs_round_dataflow"].values())
    clock("13 periphery")
    facets = phase_facets(device, card)
    clock("14 facet sweep")
    flood = phase_flood(device, card)
    clock("15 flood")
    log("done", "all phases passed in %.1f s" % (time.perf_counter() - t0))
    print(json.dumps({"kernels": [
        *dataflow_entries(k1_launches, max(k1_err, ring_err, subset_err),
                          k1, ring_ms, subset_ms), {
            "name": "uca_block_round",
            "route": "cuda",
            "source": "pydem_tpu_torch/ops/csrc/uca_block.cu",
            "replaces": "pydem_tpu/ops/uca_block.py:42",
            "launches": k2_launches,
            "max_abs_err": k2_err,
            # one round at 2048² from the base at the solvers' default
            # B = 256 (a cluster of 16 CTAs a block), and at 128, 64, 16
            "block": 256,
            "ms": k2_ms["kernel"],
            "plain_ms": k2_ms["plain"],
            "bound_ms": k2_ms["bound"],
            "bound_by": k2_ms["bound_by"],
            "library_ms": None,
            **{"b%d_%s" % (Bk, k): t[v]
               for Bk, t in k2_ms["by_block"].items()
               for k, v in (("ms", "kernel"), ("plain_ms", "plain"),
                            ("bound_ms", "bound"))},
            "launches_by_block": K2_BY_BLOCK,
        }, {
            # the facet sweep at 6000², float32 (phase 14); the JAX
            # package's sweep is jnp code, no pallas_call
            "name": "facet_sweep",
            "route": "cuda",
            "source": "pydem_tpu_torch/ops/csrc/facets.cu",
            "replaces": None,
            # as the C entry reports them, in the main paths' runs
            "launches": FACET_MAIN["launches"],
            "max_abs_err": facets["err"],
            "ms": facets["ms"],
            "plain_ms": facets["plain_ms"],
            "bound_ms": facets["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
        }, {
            # the flood at 6000² on the coast's flat mask (phase 15); the
            # JAX package's label_flood is jnp code, no pallas_call
            "name": "label_flood",
            "route": "cuda",
            "source": "pydem_tpu_torch/ops/csrc/flood.cu",
            "replaces": None,
            # as the C entry reports them, in the main paths' runs
            "launches": FLOOD_MAIN["launches"],
            "max_abs_err": 0.0,
            "ms": flood["merit-coast"]["ms"],
            "plain_ms": flood["merit-coast"]["plain_ms"],
            "bound_ms": flood["merit-coast"]["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "basin_ms": flood["merit-basin"]["ms"],
            "basin_plain_ms": flood["merit-basin"]["plain_ms"],
        }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--multicard"]:
        main_multicard()
    elif sys.argv[1:]:
        raise SystemExit("usage: python3 chip_smoke.py [--multicard]")
    else:
        main()

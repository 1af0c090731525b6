"""Multi-tile orchestration: the reference ProcessManager's capabilities on
one global canvas.

Port of ``pydem_tpu/manager.py``.  The reference pyDEM
(``process_manager.py:393-1318``) tiles a directory of overlapping GeoTIFFs,
runs per-tile subprocesses per stage, and fixed-point-iterates cross-tile UCA
edge corrections through a zarr store.  Here the tile grid is discovered the
same way (bounds snapped to a rounded lat/lon grid, ``compute_grid``,
:517-565) but the tiles are mosaicked into ONE logical canvas and the whole
pipeline runs on the device over it: the cross-tile fixed point is inherent
in the global UCA solve, so ``process_uca_edges`` exists only for
API/workflow parity (it verifies convergence state rather than iterating
rounds).  Stage outputs land in a zarr-v2-compatible store with the
reference's array names (``elev, aspect, slope, uca, edge_done, edge_todo,
twi, success``).

The manager is host code around :class:`~pydem_tpu_torch.api.DEMProcessor`;
its ``device`` keyword (default ``"cuda"``) is handed to the processor, which
raises without a GPU unless ``device="cpu"`` is asked for.  With
``out_of_core=True`` the mosaic never materialises: tiles stream into the
store and :class:`~pydem_tpu_torch.outofcore.OutOfCoreEngine` runs the
pipeline in ``superblock``-sized windows on the same device.  With ``mesh``
(a :class:`~pydem_tpu_torch.parallel.mesh.Mesh` whose devices are of the
``device``'s type) the canvases shard over the mesh: ``process_twi`` takes
the streaming route of the out-of-core engine with the engine's UCA solve
sharded (conditioning and pit links on margin windows from the store, as in
the JAX package), and the stage-by-stage calls ``process_aspect_slope`` /
``process_uca`` run :class:`~pydem_tpu_torch.parallel.sharded.
ShardedPipeline` on the mosaic.

Deliberate improvements over the reference (documented deviations):

- Elevation conditioning (fill flats / drain pits) runs on the global mosaic
  instead of per-tile, so flats spanning tile seams condition consistently.
- No subprocess pool: stage parallelism is device parallelism.
- ``process_uca_edges`` converges in zero rounds by construction.

One departure from the JAX manager: a store names the package and working
dtype that wrote it (``producer.json``), and ``resume=True`` refuses a store
written by another package or at another dtype.  The port runs float64 on
the CPU and float32 on the card, so a job preempted on one kind of worker
and stolen by another would otherwise resume from stages stored at another
precision and match neither run.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from . import default_dtype
from .api import DEMProcessor
from .geometry import pixel_scales
from .io.geotiff import write_geotiff
from .io.raw import read_raster
from .io.store import ArrayStore
from .parallel.mesh import check_mesh
from .profiling import StageTimer

# Test hook with the same meaning as process_manager.DEBUG (:52): force unit
# pixel sizes so tiling is the only variable in equivalence tests.
DEBUG = False

# Formats the from-scratch IO layer can actually read (io.geotiff +
# io.raw).  The reference lists every GDAL format extension
# (process_manager.py:458); advertising formats the reader cannot parse
# would discover tiles and then crash mid-pipeline.
_INPUT_FILE_TYPES = ("tif", "tiff", "hgt", "flt")


def _read_elev_f64(fn):
    """Read a tile's elevation as float64 with integer nodata masked to NaN
    (float tiles keep raw values, like the reference's unmasked read)."""
    g = read_raster(fn)
    data = np.asarray(g.data)
    if g.nodata is not None and np.issubdtype(data.dtype, np.integer):
        return np.where(data == g.nodata, np.nan, data.astype("float64"))
    return np.asarray(data, "float64")


class ProcessManager:
    """Discover a tile grid, mosaic it, run the terrain pipeline, export."""

    def __init__(self, in_path=".", n_workers=1, out_path=None,
                 dem_proc_kwargs=None, grid_round_decimals=2, _debug=False,
                 mesh=None, resume=False, out_of_core=False, superblock=4096,
                 measure_halo_overlap=False, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ProcessManager(device=%r): torch.cuda is not "
                               "available" % (device,))
        check_mesh(mesh, self.device)
        self.mesh = mesh
        # metrics.json: also time the halo/compute overlap on the mesh
        # (parallel.sharded.measure_halo_overlap)
        self.measure_halo_overlap = measure_halo_overlap
        self.in_path = in_path
        self.n_workers = n_workers  # accepted for API parity; device-parallel
        self.out_path = out_path or os.path.join(in_path, "results.zarr")
        self.dem_proc_kwargs = dict(dem_proc_kwargs or {})
        self.grid_round_decimals = grid_round_decimals
        self._debug = _debug
        # crash-resume: stages whose output arrays already exist in the
        # store are skipped (the reference's per-tile success-skip,
        # process_manager.py:1274-1275, at stage granularity)
        # (the out-of-core engine resumes per super-block / per UCA round)
        self.resume = resume
        # bounded-memory mode: stream S x S super-blocks through the store
        # instead of holding one canvas (see pydem_tpu_torch.outofcore)
        self.out_of_core = out_of_core
        self.superblock = superblock
        self._ooc = None

        self.elev_source_files = sorted(
            os.path.join(in_path, fn) for fn in os.listdir(in_path)
            if os.path.splitext(fn)[-1].replace(".", "") in _INPUT_FILE_TYPES)
        self.timer = StageTimer()
        self.out_file = ArrayStore(self.out_path)
        self._stamp_store()
        self.out_file_noverlap = {}
        self.index = None
        self.grid_shape = None
        self.grid_slice = []
        self._dp = None
        self._sp = None

    @property
    def n_inputs(self):
        return len(self.elev_source_files)

    # -- grid discovery (semantics of compute_grid, :517-565) -------------

    def compute_grid(self):
        """Discover the tile mosaic.

        Follows the reference's discovery discipline
        (``process_manager.py:517-565``): tile corners are snapped to a
        lat/lon grid rounded at ``grid_round_decimals`` (so float-jittered
        bounds land in the right grid cell), tiles sharing a grid row/column
        must agree on nrows/ncols (the reference's consistency asserts at
        :537-545), and — beyond the reference — pixel-pitch disagreement,
        duplicate grid cells, and off-pixel-grid alignment raise clear
        errors instead of silently mis-mosaicking.
        """
        tiles = []
        for fn in self.elev_source_files:
            # header-only: discovery is O(metadata), not O(pixels) — pixels
            # are streamed at mosaic/ingest time
            g = read_raster(fn, header_only=True)
            tiles.append(g)
        if not tiles:
            raise RuntimeError("no input rasters found in %r" % self.in_path)

        names = [os.path.basename(fn) for fn in self.elev_source_files]
        self.index = np.zeros((len(tiles), 8))
        for i, g in enumerate(tiles):
            left, bottom, right, top = g.bounds
            a, b, c, d, e, f = g.transform
            self.index[i] = [left, bottom, right, top, a, e, *g.shape]

        # all tiles must share the pixel pitch
        dlon = float(np.median(self.index[:, 4]))
        dlat = float(np.median(self.index[:, 5]))
        bad = ~(np.isclose(self.index[:, 4], dlon)
                & np.isclose(self.index[:, 5], dlat))
        if bad.any():
            raise ValueError(
                "tiles disagree on pixel pitch (median %.10g x %.10g): %s"
                % (dlon, dlat,
                   ", ".join("%s (%.10g x %.10g)" % (names[i],
                                                     self.index[i, 4],
                                                     self.index[i, 5])
                             for i in np.where(bad)[0])))

        # snap corners into the rounded grid (process_manager.py:517-521)
        rd = self.grid_round_decimals
        lats = np.round(self.index[:, 3], rd)
        lons = np.round(self.index[:, 0], rd)
        seen = {}
        for i in range(len(tiles)):
            cell = (lats[i], lons[i])
            if cell in seen:
                raise ValueError(
                    "tiles %s and %s snap to the same grid cell %r at "
                    "grid_round_decimals=%d"
                    % (names[seen[cell]], names[i], cell, rd))
            seen[cell] = i

        # per-grid-row/col shape consistency (reference asserts :537-545)
        row_rows, col_cols = {}, {}
        for i in range(len(tiles)):
            nr, nc = int(self.index[i, 6]), int(self.index[i, 7])
            prev = row_rows.setdefault(lats[i], (nr, i))
            if prev[0] != nr:
                raise ValueError(
                    "grid row at lat %r: %s has %d rows but %s has %d"
                    % (lats[i], names[prev[1]], prev[0], names[i], nr))
            prev = col_cols.setdefault(lons[i], (nc, i))
            if prev[0] != nc:
                raise ValueError(
                    "grid column at lon %r: %s has %d cols but %s has %d"
                    % (lons[i], names[prev[1]], prev[0], names[i], nc))

        # de-jittered corner per grid row/col: mean of the raw coordinates
        # that snapped together
        row_top = {v: self.index[lats == v, 3].mean() for v in set(lats)}
        col_left = {v: self.index[lons == v, 0].mean() for v in set(lons)}

        top0 = max(row_top.values())
        left0 = min(col_left.values())
        offs = []
        for i in range(len(tiles)):
            fi = (row_top[lats[i]] - top0) / dlat
            fj = (col_left[lons[i]] - left0) / dlon
            oi, oj = int(round(fi)), int(round(fj))
            if abs(fi - oi) > 0.01 or abs(fj - oj) > 0.01:
                raise ValueError(
                    "tile %s is not aligned to the mosaic pixel grid "
                    "(offset %.4f, %.4f px from the nearest cell)"
                    % (names[i], fi - oi, fj - oj))
            offs.append((oi, oj))
        n = max(o[0] + int(self.index[i, 6]) for i, o in enumerate(offs))
        m = max(o[1] + int(self.index[i, 7]) for i, o in enumerate(offs))
        self.grid_shape = (n, m)
        self.grid_slice = [
            (slice(o[0], o[0] + int(self.index[i, 6])),
             slice(o[1], o[1] + int(self.index[i, 7])))
            for i, o in enumerate(offs)]
        self.transform = (dlon, 0.0, left0, 0.0, dlat, top0)
        self._projected = getattr(tiles[0], "projected", False)
        self._crs_code = getattr(tiles[0], "crs_code", 4326)
        self._ellipsoid = getattr(tiles[0], "ellipsoid", "WGS-84")
        return self.grid_shape

    # -- mosaic + pipeline --------------------------------------------------

    def _mosaic_elev(self):
        n, m = self.grid_shape
        canvas = np.full((n, m), np.nan)
        disagree = 0
        for fn, slc in zip(self.elev_source_files, self.grid_slice):
            new = _read_elev_f64(fn)
            old = canvas[slc]
            both = np.isfinite(old) & np.isfinite(new)
            # overlap-value disagreement check (the reference tolerates
            # 1e-8 between concurrent writers, process_manager.py:356-357)
            disagree += int((np.abs(old[both] - new[both]) > 1e-8).sum())
            canvas[slc] = np.where(np.isfinite(new), new, old)
        if disagree:
            import warnings

            warnings.warn("%d overlapping pixels disagree between tiles "
                          "(later tiles win)" % disagree)
        return canvas

    def _pixel_vectors(self):
        n = self.grid_shape[0]
        if DEBUG or self._debug:
            return (np.ones(n - 1), np.ones(n - 1), np.ones(n), np.ones(n))
        return pixel_scales(self.transform, n, projected=self._projected,
                            ellipsoid=getattr(self, "_ellipsoid", "WGS-84"))

    def _processor(self):
        if self._dp is not None:
            return self._dp
        elev = self._mosaic_elev()
        dX, dY, dX2, dY2 = self._pixel_vectors()
        self._dp = DEMProcessor(elev=elev, dX=dX, dY=dY, dX2=dX2, dY2=dY2,
                                device=self.device, **self.dem_proc_kwargs)
        return self._dp

    PRODUCER = "producer.json"

    def _stamp_store(self):
        """Name this run's package and dtype in the store; with ``resume``,
        first refuse a store that holds arrays another writer left."""
        want = {"package": "pydem_tpu_torch",
                "dtype": str(default_dtype(self.device)).split(".")[-1]}
        fn = os.path.join(self.out_path, self.PRODUCER)
        if self.resume and self.out_file.names():
            have = None
            if os.path.exists(fn):
                with open(fn) as f:
                    have = json.load(f)
            if have != want:
                raise ValueError(
                    "resume: the store %s was written by %s, this run is %s; "
                    "resuming would mix their stages (remove the store, or "
                    "resume on the kind of device that started it)"
                    % (self.out_path, have or "another package (no %s)"
                       % self.PRODUCER, want))
        with open(fn, "w") as f:
            json.dump(want, f)

    def _resume_hit(self, key):
        return self.resume and key in self.out_file

    # -- fault isolation / success bookkeeping -----------------------------
    #
    # The reference wraps every per-tile worker in try/except returning
    # (0, traceback) (process_manager.py:69-70,195-196,282-283) and persists
    # a per-tile per-stage boolean ``success`` array (:998-999) so a crashed
    # run resumes by skipping finished work (:1274-1275).  Stages here are
    # global-canvas programs, so the honest granularity is per *stage*: the
    # success array keeps the reference's (n_inputs, 4) layout
    # (columns: elevation, aspect_slope, uca, twi) and a stage's column is
    # set for all tiles the moment that stage's outputs are durably in the
    # store — never before.  A stage exception is captured with its
    # traceback into <store>/errors.json (the (0, traceback) analog), the
    # bookkeeping is persisted, and the error re-raised; a later
    # ``resume=True`` run redoes only the unfinished stages, bit-identically
    # (stages are deterministic functions of the stored inputs).
    _SUCCESS_STAGES = ("elevation", "aspect_slope", "uca", "twi")

    def _success_init(self):
        if "success" in self.out_file and self.resume:
            s = self.out_file["success"]
            if s.shape == (self.n_inputs, 4):
                return s
        s = np.zeros((self.n_inputs, 4), bool)
        self.out_file["success"] = s
        return s

    def _mark_success(self, stage):
        s = self.out_file["success"] if "success" in self.out_file \
            else np.zeros((self.n_inputs, 4), bool)
        if s.shape != (self.n_inputs, 4):
            s = np.zeros((self.n_inputs, 4), bool)
        s[:, self._SUCCESS_STAGES.index(stage)] = True
        self.out_file["success"] = s

    def _record_error(self, stage, exc):
        import traceback

        entry = {"stage": stage,
                 "error": repr(exc),
                 "traceback": traceback.format_exc()}
        fn = os.path.join(self.out_path, "errors.json")
        log = []
        if os.path.exists(fn):
            try:
                with open(fn) as f:
                    log = json.load(f)
            except Exception:
                log = []
        log.append(entry)
        with open(fn, "w") as f:
            json.dump(log, f, indent=2)

    def _stage_guarded(self, stage, fn):
        """Run one pipeline stage with worker-style fault capture."""
        try:
            out = fn()
        except Exception as exc:
            self._record_error(stage, exc)
            self._dump_metrics()
            raise
        self._mark_success(stage)
        return out

    def process_elevation(self, indices=None):
        if self.grid_shape is None:
            self.compute_grid()
        dp = self._processor()
        if self._resume_hit("elev"):
            dp.elev = self.out_file["elev"]
            dp.fill_flats = False
            dp.drain_pits_path = False
            return dp.elev
        with self.timer.stage("elevation"):
            if dp.fill_flats:
                dp.calc_fill_flats()
            if dp.drain_pits_path:
                dp.calc_pit_drain_paths()
        self.out_file["elev"] = dp.elev
        return self.out_file["elev"]

    def _sharded_pipeline(self):
        """The mesh pipeline over the conditioned mosaic, built once."""
        if self._sp is None:
            from .parallel.sharded import ShardedPipeline

            dp = self._processor()
            self._sp = ShardedPipeline(dp.elev, dp.dX, dp.dY, dp.dX2, dp.dY2,
                                       self.mesh,
                                       uca_solver=dp._resolved_solver())
        return self._sp

    def process_aspect_slope(self, indices=None):
        dp = self._processor()
        # conditioning already applied by process_elevation; DEMProcessor
        # re-runs are guarded by its flags
        dp.fill_flats = False
        dp.drain_pits_path = False
        if self._resume_hit("aspect") and self._resume_hit("slope"):
            dp.direction = self.out_file["aspect"]
            dp.mag = self.out_file["slope"]
            dp.flats = dp.mag == -1
            return dp.mag, dp.direction
        with self.timer.stage("aspect_slope"):
            if self.mesh is not None:
                dp.mag, dp.direction, dp.flats = \
                    self._sharded_pipeline().pre()
            else:
                dp.calc_slopes_directions()
        self.out_file["aspect"] = dp.direction
        self.out_file["slope"] = dp.mag
        return dp.mag, dp.direction

    def process_uca(self, indices=None):
        dp = self._processor()
        state_fn = os.path.join(self.out_path, "_uca_state.json")
        if self._resume_hit("uca"):
            dp.uca = self.out_file["uca"]
            # restore the solve-time scalars TWI depends on (twi_min_area
            # feeds the saturation caps) so a resumed TWI is bit-identical
            if os.path.exists(state_fn):
                with open(state_fn) as f:
                    st = json.load(f)
                dp.twi_min_area = min(dp.twi_min_area, st["twi_min_area"])
                dp.uca_sweeps = st.get("uca_sweeps", -1)
            return dp.uca
        with self.timer.stage("uca"):
            if self.mesh is not None:
                self._sharded_uca(dp)
            else:
                dp.calc_uca()
        # real edge state from the solve: canvas-boundary pixels that await
        # inflow from OUTSIDE the mosaic stay todo (dem_processing.py:
        # 909-930); everything else is done by construction of the global
        # solve.  A state without edge bookkeeping (a resumed run whose uca
        # was loaded, or the mesh route) counts as all-done.
        if dp._has("edge_todo"):
            self.out_file["edge_todo"] = np.asarray(dp.edge_todo)
            self.out_file["edge_done"] = np.asarray(dp.edge_done)
        else:
            self.out_file["edge_todo"] = np.zeros(dp.uca.shape, bool)
            self.out_file["edge_done"] = np.ones(dp.uca.shape, bool)
        with open(state_fn, "w") as f:
            json.dump({"twi_min_area": float(dp.twi_min_area),
                       "uca_sweeps": int(getattr(dp, "uca_sweeps", -1))}, f)
        # the 'uca' array LAST: _resume_hit("uca") takes the skip path on its
        # presence alone, so every other artifact the resumed run needs
        # (edge_todo/edge_done/_uca_state.json) must already be durable
        self.out_file["uca"] = dp.uca
        return dp.uca

    def _sharded_uca(self, dp):
        """The UCA stage over the mesh: the host's pit links (the spill
        mode's connectivity needs section), the sharded solve."""
        if dp.direction is None:
            self.process_aspect_slope()
        sp = self._sharded_pipeline()
        if dp.drain_pits_spill and not (dp.drain_pits or dp.drain_flats):
            from .api import _section_program

            section, proportion = _section_program(
                dp._to_dev(dp.direction), dp._to_dev(dp.flats),
                dp._to_dev(dp.dX), dp._to_dev(dp.dY))
            dp.section = section.cpu().numpy()
            dp.proportion = proportion.cpu().numpy()
        pit_src, pit_dst, pit_w, flats2, mag2 = dp._drain_links()
        keep = pit_w > 1e-8  # pruning, dem_processing.py:1136
        area, rounds = sp.uca((pit_src[keep], pit_dst[keep], pit_w[keep]))
        dp.uca = np.where(flats2, np.nan, area)
        dp.mag = np.asarray(mag2)
        dp.flats = np.asarray(flats2)
        dp.uca_sweeps = rounds
        dp.twi_min_area = min(dp.twi_min_area, sp.min_area)

    def process_uca_edges(self, indices=None):
        """Cross-tile UCA edge resolution.

        The global solve already propagates across all former tile seams, so
        this stage only records the converged edge state (the reference's
        fixed-point rounds, :1090-1249, collapse to zero iterations here).
        """
        dp = self._processor()
        if dp.uca is None:
            self.process_uca()
        self.out_file["uca_edges"] = dp.uca
        # The reference's (p_done, n_done) scheduler signal, computed with
        # calc_uca_ec_metrics semantics (process_manager.py:199-221):
        # per tile, coulddo = its todo-edge pixels whose adjacent neighbor
        # strip is done; p_done = coulddo / (1e-16 + n_todo),
        # n_done = coulddo.  On the solved global canvas interior seams
        # carry no todo (resolved by construction) and mosaic-boundary
        # strips have no neighbor (excluded, like the reference's absent
        # edge_slc keys), so converged runs report (0, 0) — "nothing left
        # that could be done", the loop-exit state of process_uca_edges.
        todo = self.out_file["edge_todo"]
        done = self.out_file["edge_done"]
        n, m = self.grid_shape
        metrics = np.zeros((self.n_inputs, 2))
        for i, (si, sj) in enumerate(self.grid_slice):
            p = 0
            nd = 0
            sides = []
            if si.start > 0:
                sides.append((todo[si.start, sj], done[si.start - 1, sj]))
            if si.stop < n:
                sides.append((todo[si.stop - 1, sj], done[si.stop, sj]))
            if sj.start > 0:
                sides.append((todo[si, sj.start], done[si, sj.start - 1]))
            if sj.stop < m:
                sides.append((todo[si, sj.stop - 1], done[si, sj.stop]))
            for et, edn in sides:
                nd += int((et & edn).sum())
                p += int(et.sum())
            metrics[i] = (nd / (1e-16 + p), nd)
        self.out_file["uca_edge_metrics"] = metrics
        return 0  # rounds needed

    # -- bounded-memory (out-of-core) pipeline -------------------------------

    def _ingest_out_of_core(self, S):
        """Stream tiles into the store canvas one at a time (the mosaic
        never materializes; NaN pixels of later tiles don't clobber data
        from earlier overlapping tiles)."""
        if self.resume and "elev_src" in self.out_file:
            return
        self.out_file.create("elev_src", self.grid_shape, "float64",
                             chunks=(S, S), fill=np.nan, overwrite=True)
        for fn, slc in zip(self.elev_source_files, self.grid_slice):
            new = _read_elev_f64(fn)
            cur = self.out_file.read_window(
                "elev_src", (slc[0].start, slc[0].stop),
                (slc[1].start, slc[1].stop))
            self.out_file.write_window(
                "elev_src", np.where(np.isfinite(new), new, cur),
                (slc[0].start, slc[1].start))

    def _process_twi_out_of_core(self):
        from .outofcore import OutOfCoreEngine

        if self.grid_shape is None:
            self.compute_grid()
        dX, dY, dX2, dY2 = self._pixel_vectors()
        eng = OutOfCoreEngine(self.out_file, self.grid_shape, dX, dY, dX2,
                              dY2, dem_proc_kwargs=self.dem_proc_kwargs,
                              superblock=self.superblock, resume=self.resume,
                              timer=self.timer, mesh=self.mesh,
                              device=self.device)
        self._ooc = eng
        with self.timer.stage("ingest"):
            self._ingest_out_of_core(eng.S)
        eng.run()
        # store-surface parity with the in-core stages: the global solve
        # leaves no pending cross-tile work, so the edge state is constant
        # (lazy fill-value arrays: nothing canvas-sized materializes) and
        # the scheduler metrics are the loop-exit (0, 0)
        n, m = self.grid_shape
        if "edge_todo" not in self.out_file:
            self.out_file.create("edge_todo", (n, m), "bool", fill=False)
            self.out_file.create("edge_done", (n, m), "bool", fill=True)
        if "uca_edges" not in self.out_file:
            self.out_file.create("uca_edges", (n, m), eng._work_dtype,
                                 fill=np.nan)
            S = eng.S
            for i0 in range(0, n, S):
                for j0 in range(0, m, S):
                    w = self.out_file.read_window(
                        "uca", (i0, min(i0 + S, n)), (j0, min(j0 + S, m)))
                    self.out_file.write_window("uca_edges", w, (i0, j0))
        self.out_file["uca_edge_metrics"] = np.zeros((self.n_inputs, 2))
        self.out_file["success"] = np.ones((self.n_inputs, 4), bool)
        self._dump_metrics()
        return self.out_file

    def process_twi(self):
        # A mesh run takes the streaming route even when out_of_core is off,
        # as in the JAX package: conditioning and pit links run on margin
        # windows from the store and the canvases gather into the device
        # pass, so the mosaic is never conditioned whole on the host.
        # Stage-by-stage calls (process_elevation, ...) keep the in-memory
        # behaviour.
        if self.out_of_core or self.mesh is not None:
            out = self._process_twi_out_of_core()
            if self.out_of_core:
                return out  # the store handle: the canvas never materializes
            return self.out_file["twi"]  # the in-memory return contract
        if self.grid_shape is None:
            self.compute_grid()
        self._success_init()
        self._stage_guarded("elevation", self.process_elevation)
        self._stage_guarded("aspect_slope", self.process_aspect_slope)
        self._stage_guarded("uca", self.process_uca)
        self.process_uca_edges()
        dp = self._processor()

        def _twi():
            if self._resume_hit("twi"):
                dp.twi = self.out_file["twi"]
                return dp.twi
            with self.timer.stage("twi"):
                dp.calc_twi()
            self.out_file["twi"] = dp.twi
            return dp.twi

        twi = self._stage_guarded("twi", _twi)
        self._dump_metrics()
        return twi

    def _dump_metrics(self):
        """Persist run observability into the store (BASELINE.md metrics:
        stage seconds, UCA iterations to convergence, halo-exchange
        fraction)."""
        dp = self._dp
        metrics = {
            "stage_seconds": self.timer.report(),
            "uca_iters_to_converge": int(getattr(dp, "uca_sweeps", -1))
            if dp is not None else -1,
            "canvas_shape": list(self.grid_shape or ()),
            "n_tiles": self.n_inputs,
        }
        if self._sp is not None:
            metrics.update(self._sp.halo_metrics(
                measure=self.measure_halo_overlap))
        if self._ooc is not None:
            metrics["uca_iters_to_converge"] = int(self._ooc.uca_rounds)
            metrics["halo_fraction"] = self._ooc.halo_fraction()
        with open(os.path.join(self.out_path, "metrics.json"), "w") as f:
            json.dump(metrics, f, indent=2)
        return metrics

    # -- export -------------------------------------------------------------

    def save_non_overlap_data(self, keys=None, out_path=None,
                              chunk=1024):
        """De-overlapped compact export store (reference
        ``save_non_overlap_data``, process_manager.py:742-784).

        The mosaic canvas is already overlap-free, so the compact geometry
        equals the canvas geometry; what this stage does — like the
        reference — is a REAL windowed copy into a second store
        (``<out_path or in_path>/results_noverlap.zarr``), streamed
        chunk-by-chunk in O(chunk²) memory so an out-of-core-sized store
        exports without ever materializing a canvas.  Returns the compact
        :class:`ArrayStore` (dict-like: ``store["uca"]`` reads a full
        array, ``read_window`` streams)."""
        keys = keys or ["elev", "aspect", "slope", "uca", "twi"]
        out_path = out_path or os.path.join(self.in_path,
                                            "results_noverlap.zarr")
        dst = ArrayStore(out_path)
        for key in keys:
            if key not in self.out_file:
                continue
            meta = self.out_file._meta(key)
            shape = meta["shape"]
            dt = np.dtype(meta["dtype"]).name
            dst.create(key, shape, dt,
                       chunks=[min(chunk, shape[0]), min(chunk, shape[1])],
                       fill=np.nan if np.dtype(dt).kind == "f" else 0,
                       overwrite=True)
            for i0 in range(0, shape[0], chunk):
                for j0 in range(0, shape[1], chunk):
                    i1 = min(i0 + chunk, shape[0])
                    j1 = min(j0 + chunk, shape[1])
                    dst.write_window(
                        key,
                        self.out_file.read_window(key, (i0, i1), (j0, j1)),
                        (i0, j0))
        self.out_file_noverlap = dst
        return dst

    def save_non_overlap_data_geotiff(self, out_path=None, keys=None,
                                      overview_factors=(3, 9, 27),
                                      resampling="mean"):
        """GeoTIFF export + mean-downsampled overview pyramid (factors 3^k,
        the reference's scheme at :786-931).

        STREAMING by default: every output is written through
        ``TiledTiffWriter`` windows read chunk-by-chunk from the store, with
        the overview pyramid embedded as subsequent IFDs — no full-canvas
        array is ever materialized, so an out-of-core store exports in
        O(tile) memory (the reference's rasterio-windows discipline,
        process_manager.py:829-858)."""
        out_path = out_path or os.path.join(self.in_path, "results_geotiff")
        os.makedirs(out_path, exist_ok=True)
        keys = keys or ["elev", "aspect", "slope", "uca", "twi"]
        written = []
        for key in keys:
            if key not in self.out_file:
                continue
            fn = os.path.join(out_path, key + ".tif")
            self.save_geotiff_tiled(key, fn,
                                    overview_factors=overview_factors,
                                    resampling=resampling)
            written.append(fn)
        return written

    def save_geotiff(self, key, fn):
        write_geotiff(fn, self.out_file[key].astype("float32"),
                      self.transform, nodata=-9999, compress=True,
                      crs_code=getattr(self, "_crs_code", 4326),
                      projected=self._projected)

    def save_geotiff_tiled(self, key, fn, overview_factors=(3, 9, 27),
                           bigtiff="auto", tile=256, nodata=-9999.0,
                           resampling="mean"):
        """Windowed tiled GeoTIFF/BigTIFF export with embedded overview
        pyramids — the reference's huge-raster path
        (process_manager.py:786-931: tiled LZW bigtiff + build_overviews),
        streamed from the store so the raster is never materialized."""
        from .io.bigtiff import TiledTiffWriter

        meta = self.out_file._meta(key)
        shape = meta["shape"]
        factors = [f for f in overview_factors if min(shape) // f >= 1]
        with TiledTiffWriter(fn, shape, "float32", transform=self.transform,
                             nodata=nodata, tile=tile, bigtiff=bigtiff,
                             crs_code=getattr(self, "_crs_code", 4326),
                             projected=self._projected) as w:
            for i0 in range(0, shape[0], tile):
                band = self.out_file.read_window(
                    key, (i0, min(i0 + tile, shape[0])),
                    (0, shape[1])).astype("float32")
                band = np.where(np.isnan(band), np.float32(nodata), band)
                w.write_window(band, (i0, 0))

            def rw(rows, cols):
                return self.out_file.read_window(key, rows,
                                                 cols).astype("float32")

            w.build_overviews(factors, rw, method=resampling)
        return fn

    def process_overviews(self, keys=("twi",), factors=(3, 9, 27),
                          method="mean"):
        """Store overview pyramids in the zarr store (reference :933-991)."""
        for key in keys:
            data = self.out_file[key]
            for fac in factors:
                if min(data.shape) // fac < 1:
                    break
                self.out_file["%s_%d" % (key, fac)] = _mean_downsample(
                    data, fac, method)


def _mean_downsample(data, fac, method="mean"):
    """Overview resampling (reference accepts any rasterio
    Resampling.<type>, process_manager.py:853-858, 964-966; implemented:
    mean/average, nearest, bilinear, cubic — io.resample)."""
    from .io.resample import downsample

    return downsample(data, fac, method)

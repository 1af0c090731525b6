"""Single-tile API: :class:`DEMProcessor`.

Port of ``pydem_tpu/api.py``: same constructor conventions (a raster file or
an in-memory array, dX/dY as scalars or per-row arrays), same public methods
(``calc_fill_flats``, ``calc_pit_drain_paths``, ``calc_slopes_directions``,
``calc_uca``, ``calc_twi``, ``find_flats``), same tunables, defaults and
``CONFIG_KEYS`` as the JAX package, plus ``device`` (default ``"cuda"``;
never chosen by what is available: without a GPU the constructor raises, and
the CPU is used only when asked for with ``device="cpu"``).  Floats are
:func:`pydem_tpu_torch.default_dtype` of the device.

Two routes, as in the JAX package:

- the host-state route (the default backends): conditioning runs on the host
  (:mod:`.core.conditioning`), each stage uploads its inputs, runs its
  stencil program on the device and stores numpy state;
- the device chain (``conditioning_backend="device"``,
  ``pit_backend="device"``, ``drain_pits=True``): flat filling, pit gate,
  the host carve's delta, slope/flats/section, pit links, the UCA fixed
  point and TWI run on the device; only the pit carve runs on the host, in
  C++ (:mod:`pydem_tpu_torch.native`), and only the carved pixels travel
  back.  State arrays stay on the device and their numpy views are fetched
  on first read (:class:`_Field`).

Differences from the JAX version, by design: the pit links and the carve
delta are not padded to power-of-two buckets (they kept XLA's compile keys
stable; eager PyTorch compiles nothing), and the solve's sweep or round
count is a Python int (the solvers read one host flag per round anyway).
"""
from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as F

from . import default_dtype
from .core import conditioning as cond
from .core.flats_device import fill_flats_device
from .core.receivers import receiver_weights, section_proportion
from .core.slope_direction import find_flats_edges, slopes_directions
from .core.stencil import NEIGHBOR_OFFSETS, shift
from .core.uca import (accumulate, accumulate_update, base_area, finalize_uca,
                       grid_edge_mask, reachability, seeds_and_edge_todo)
from .io.raw import read_raster_kwargs
from .ops.pit_growth import connectivity_pits_device, pit_links_device_packed
from .parallel.sharded import _block_size

FLAT_ID_INT = -1

# Instrumentation hook: when set, called at the device chain's stage
# boundaries as hook(name, tensor_or_None).  None in production.
_stage_probe = None


def _probe(name, val=None):
    if _stage_probe is not None:
        _stage_probe(name, val)


def _nanmin(a):
    return torch.where(torch.isnan(a), torch.inf, a).min()


def _slope_program(elev, dX, dY):
    """mag/direction + downstream-extended flats."""
    mag, direction = slopes_directions(elev, dX, dY)
    flats = find_flats_edges(elev, mag)
    direction = torch.where(flats, FLAT_ID_INT, direction)
    mag = torch.where(flats, FLAT_ID_INT, mag)
    return mag, direction, flats


_section_program = section_proportion


def _pre_program(elev, dX, dY):
    """slope/direction + flats + section/proportion."""
    mag, direction, flats = _slope_program(elev, dX, dY)
    section, proportion = _section_program(direction, flats, dX, dY)
    return mag, direction, flats, section, proportion


def _has_pits_program(elev, below_sea=False):
    """Any pit present?  (ring minimum strictly above the centre, inside the
    sea mask: the pit test of ``drain_pit_paths``.)  ``fmin``: a NaN
    (no-data) neighbour counts as +inf.  A 0-dim bool tensor."""
    mn = torch.full_like(elev, torch.inf)
    for di, dj in NEIGHBOR_OFFSETS:
        mn = torch.fmin(mn, shift(elev, di, dj, float("inf")))
    sea = (elev != 0) if below_sea else (elev > 0)
    return ((mn > elev) & sea).any()


def _apply_carve_delta(elev_d, idx, vals):
    """The canvas with the host-carved pixels ``idx`` (flat, unique) set to
    ``vals``: bit-identical to uploading the carved canvas."""
    out = elev_d.reshape(-1).clone()
    out[idx] = vals
    return out.view(elev_d.shape)


def _solve_uca(base, W, shape, pit_src, pit_dst, pit_w, max_iters,
               check_every, solver, block_size):
    """Jacobi sweeps, or blocked rounds (K1) on the canvas zero-padded to the
    block grid (exact: pad pixels carry no weight and no base area), with
    the pit indices remapped into the padded canvas."""
    if solver == "jacobi":
        return accumulate(base, W, pit_src, pit_dst, pit_w,
                          max_iters=max_iters, check_every=check_every)
    if solver != "blocked":
        raise ValueError("uca_solver must be 'jacobi', 'blocked' or 'auto', "
                         "got %r" % (solver,))
    from .ops.uca_block import (accumulate_blocked_gs,
                                 accumulate_blocked_pits_gs)

    n, m = shape
    B = block_size or _block_size(n, m)
    pn, pm = (-n) % B, (-m) % B
    base_p = F.pad(base, (0, pm, 0, pn))
    W_p = F.pad(W, (0, pm, 0, pn))
    if pit_src is None:
        area, n_sweeps = accumulate_blocked_gs(base_p, W_p, B=B)
    else:
        def remap(idx):
            return (idx // m) * (m + pm) + idx % m

        area, n_sweeps = accumulate_blocked_pits_gs(
            base_p, W_p, remap(pit_src), remap(pit_dst), pit_w, B=B)
    return area[:n, :m], n_sweeps


def _uca_program(elev, section, proportion, flats2, dX2, dY2, pit_src,
                 pit_dst, pit_w, max_iters, check_every, solver="jacobi",
                 block_size=None):
    """The UCA stage of the host-state route: receiver planes and base,
    the fixed point, flats masked.  ``pit_src`` None: no links.  Returns
    ``(area, n_sweeps, min_area, edge_todo)``."""
    W = receiver_weights(section, proportion, elev)
    base = base_area(dX2, dY2, elev.shape, elev.dtype)
    min_area = _nanmin(base)
    area, n_sweeps = _solve_uca(base, W, elev.shape, pit_src, pit_dst, pit_w,
                                max_iters, check_every, solver, block_size)
    area = finalize_uca(area, flats2)
    edge_todo = seeds_and_edge_todo(W, section, elev)
    return area, n_sweeps, min_area, edge_todo


def _uca_chain_program(elev, section, proportion, flats, mag, dX2, dY2,
                       pit_src, pit_dst, pit_w, drained_idx, drained_mag,
                       has_pits, has_drained, max_iters, check_every,
                       solver="jacobi", block_size=None):
    """The UCA stage: apply the drained pits' flats/mag updates, build the
    receiver planes and base, solve the fixed point.  Returns ``(area,
    n_sweeps, min_area, edge_todo, flats, mag)``."""
    if has_drained:
        # the sentinel n*m marks pits that did not drain: mask it out
        keep = drained_idx < flats.numel()
        idx = drained_idx[keep]
        flats = flats.reshape(-1).clone()
        flats[idx] = False
        flats = flats.view(elev.shape)
        mag = mag.reshape(-1).clone()
        mag[idx] = drained_mag[keep].to(mag.dtype)
        mag = mag.view(elev.shape)
    W = receiver_weights(section, proportion, elev)
    base = base_area(dX2, dY2, elev.shape, elev.dtype)
    min_area = _nanmin(base)
    pits = (pit_src, pit_dst, pit_w) if has_pits else (None, None, None)
    area, n_sweeps = _solve_uca(base, W, elev.shape, *pits, max_iters,
                                check_every, solver, block_size)
    area = finalize_uca(area, flats)
    edge_todo = seeds_and_edge_todo(W, section, elev)
    return area, n_sweeps, min_area, edge_todo, flats, mag


def _twi_program(uca, mag, min_area, min_slope, sat_limit, on_uca, limits):
    """TWI (dem_processing.py:1647-1677 semantics), ×10 as stored."""
    twi = uca
    if on_uca:
        twi = torch.minimum(twi, sat_limit * min_area)
    twi = torch.log(twi / (mag + min_slope))
    if limits:
        twi = torch.minimum(twi, torch.log(sat_limit * min_area / min_slope))
    return twi * 10


def _edge_flood_program(elev, section, proportion, edge_todo, pit_src,
                        pit_dst, pit_w):
    """Flood the initial edge-todo mask downstream through the drainage
    graph: the ``edge_todo[j] += edge_todo[i]*w`` propagation the reference
    performs during the fresh solve, whose boolean complement is its
    ``edge_done`` (dem_processing.py:973-975).  On the pruned DAG the
    done-gated edge skip never fires in a fresh solve, so the flood is plain
    reachability.  ``pit_src`` None: no links."""
    W = receiver_weights(section, proportion, elev)
    return reachability(edge_todo, W, pit_src, pit_dst, pit_w)


class _Field:
    """State array that lives on the host (numpy) or the device (a tensor).

    The device chain keeps intermediates on the device; this descriptor
    fetches the numpy view on first attribute read and caches it.  A plain
    assignment stores a host array and drops the device copy."""

    def __set_name__(self, owner, name):
        self.name = name
        self._np = "_np_" + name
        self._dev = "_dev_" + name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        val = obj.__dict__.get(self._np)
        if val is None:
            dev = obj.__dict__.get(self._dev)
            if dev is not None:
                val = dev.cpu().numpy()
                obj.__dict__[self._np] = val
        return val

    def __set__(self, obj, value):
        obj.__dict__[self._np] = value
        obj.__dict__[self._dev] = None


class DEMProcessor:
    """Compute D∞ slope/aspect, UCA, and TWI for one elevation raster."""

    elev = _Field()
    mag = _Field()
    direction = _Field()
    flats = _Field()
    section = _Field()
    proportion = _Field()
    uca = _Field()
    twi = _Field()
    edge_todo = _Field()

    # conditioning tunables (dem_processing.py:105-127 defaults)
    fill_flats = True
    fill_flats_below_sea = False
    fill_flats_source_tol = 1
    fill_flats_peaks = True
    fill_flats_pits = True
    fill_flats_max_iter = 10

    drain_pits = True
    drain_pits_path = True
    drain_pits_min_border = False
    drain_pits_spill = False
    drain_flats = False
    drain_pits_max_iter = 300
    drain_pits_max_dist = 32
    drain_pits_max_dist_XY = None

    apply_uca_limit_edges = False
    apply_twi_limits = False
    apply_twi_limits_on_uca = False

    uca_saturation_limit = 32
    twi_min_slope = 1e-3
    maximum_pit_area = 32
    circular_ref_maxcount = 50

    # UCA solver controls
    uca_check_every = 4
    uca_max_iters = 1_000_000
    # "host" = the reference's exact semantics in numpy/scipy
    # (core.conditioning); "device" = the label-flood / segment-reduction
    # implementation on the device (core.flats_device)
    conditioning_backend = "host"
    # "host" = serial per-pit growth; "device" = all pits grown at once in
    # windows (ops.pit_growth)
    pit_backend = "host"
    # "jacobi" = global sweeps; "blocked" = block rounds (the CUDA kernel on
    # a GPU); "auto" = blocked on CUDA with min(n, m) >= 256, else jacobi
    uca_solver = "auto"
    # block size for the blocked solver (None: the JAX rule, 256, or 128
    # below 256 px)
    uca_block_size = None

    CONFIG_KEYS = [
        "fill_flats", "fill_flats_below_sea", "fill_flats_source_tol",
        "fill_flats_peaks", "fill_flats_pits", "fill_flats_max_iter",
        "drain_pits", "drain_pits_path", "drain_pits_min_border",
        "drain_pits_spill", "drain_flats", "drain_pits_max_iter",
        "drain_pits_max_dist", "drain_pits_max_dist_XY",
        "apply_uca_limit_edges", "apply_twi_limits", "apply_twi_limits_on_uca",
        "uca_saturation_limit", "twi_min_slope", "maximum_pit_area",
        "circular_ref_maxcount", "uca_check_every", "uca_max_iters",
        "conditioning_backend", "pit_backend", "uca_solver",
        "uca_block_size",
    ]

    def __init__(self, elev_fn=None, device="cuda", **kwargs):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DEMProcessor(device=%r): torch.cuda is not "
                               "available" % (device,))
        self.dtype = default_dtype(self.device)

        if elev_fn:
            kwds = read_raster_kwargs(elev_fn)
            kwds.update(kwargs)
            kwargs = kwds

        elev = np.asarray(kwargs.pop("elev"))
        if np.ma.isMaskedArray(elev):
            elev = np.ma.filled(elev.astype("float64"), np.nan)
        self.elev = np.asarray(elev, dtype="float64")
        n = self.elev.shape[0]

        dX = kwargs.pop("dX", None)
        dY = kwargs.pop("dY", None)
        dX2 = kwargs.pop("dX2", None)
        dY2 = kwargs.pop("dY2", None)
        if not isinstance(dX, np.ndarray):
            if dX2 is None:
                dX2 = np.ones(n) * (1 if dX is None else dX)
            dX = np.ones(n - 1) * (1 if dX is None else dX)
        if not isinstance(dY, np.ndarray):
            if dY2 is None:
                dY2 = np.ones(n) * (1 if dY is None else dY)
            dY = np.ones(n - 1) * (1 if dY is None else dY)
        if dX2 is None:
            dX2 = np.ones(n)
        if dY2 is None:
            dY2 = np.ones(n)
        self.dX, self.dY = np.asarray(dX, "float64"), np.asarray(dY, "float64")
        self.dX2 = np.asarray(dX2, "float64")
        self.dY2 = np.asarray(dY2, "float64")

        self.bounds = kwargs.pop("bounds", None)
        self.transform = kwargs.pop("transform", None)

        self.direction = kwargs.pop("direction", None)
        self.mag = kwargs.pop("mag", None)
        self.uca = kwargs.pop("uca", None)
        self.twi = kwargs.pop("twi", None)
        self.flats = kwargs.pop("flats", None)
        self.section = None
        self.proportion = None
        self.edge_todo = None
        self.edge_done = None
        self.twi_min_area = np.inf

        for key, val in kwargs.items():
            if key not in self.CONFIG_KEYS:
                raise TypeError("Unknown DEMProcessor option %r" % key)
            setattr(self, key, val)

        # two reference options are deliberate no-ops (docs/PARITY.md)
        for key, default in (("circular_ref_maxcount", 50),
                             ("fill_flats_max_iter", 10)):
            if key in kwargs and kwargs[key] != default:
                warnings.warn(
                    "%s=%r has no effect in pydem_tpu_torch (see "
                    "docs/PARITY.md): the reference behavior it tunes is "
                    "inert by design" % (key, kwargs[key]), stacklevel=2)

    def _resolved_solver(self):
        """``uca_solver``, with "auto" resolved: blocked on CUDA for a canvas
        of at least 256 px a side, jacobi otherwise."""
        if self.uca_solver != "auto":
            return self.uca_solver
        arr = self._dev("elev")
        if arr is None:
            arr = self.__dict__.get("_np_elev")
        n, m = arr.shape if arr is not None else (0, 0)
        return ("blocked" if self.device.type == "cuda" and min(n, m) >= 256
                else "jacobi")

    # -- solve scalars -----------------------------------------------------

    @property
    def uca_sweeps(self):
        return self.__dict__.get("_uca_sweeps", -1)

    @uca_sweeps.setter
    def uca_sweeps(self, v):
        self.__dict__["_uca_sweeps"] = int(v)

    @property
    def twi_min_area(self):
        """The smallest base area seen by any solve (a host float); a
        pending device value is folded in on first read."""
        d = self.__dict__.pop("_min_area_dev", None)
        if d is not None:
            self.__dict__["_twi_min_area"] = min(
                self.__dict__.get("_twi_min_area", np.inf), float(d))
        return self.__dict__.get("_twi_min_area", np.inf)

    @twi_min_area.setter
    def twi_min_area(self, v):
        self.__dict__["_twi_min_area"] = v

    def _twi_min_area_device(self, like):
        """min_area as a 0-dim tensor like ``like``, without a host read."""
        host = torch.tensor(self.__dict__.get("_twi_min_area", np.inf),
                            dtype=like.dtype, device=like.device)
        pend = self.__dict__.get("_min_area_dev")
        return host if pend is None else torch.minimum(host,
                                                       pend.to(like.dtype))

    def _dev(self, name):
        return self.__dict__.get("_dev_" + name)

    def _set_dev(self, name, val):
        self.__dict__["_dev_" + name] = val
        self.__dict__["_np_" + name] = None

    def _has(self, name):
        """Whether the field is populated, without a fetch."""
        return (self.__dict__.get("_np_" + name) is not None
                or self.__dict__.get("_dev_" + name) is not None)

    def _to_dev(self, a):
        """A host array on the processor's device: floats in its float
        dtype, integer and bool planes as they are."""
        a = np.asarray(a)
        return torch.as_tensor(a, dtype=self.dtype if a.dtype.kind == "f"
                               else None, device=self.device)

    def _field_dev(self, name):
        """The field as a device tensor: the device copy when the chain left
        one, else an upload of the host array."""
        d = self._dev(name)
        return d if d is not None else self._to_dev(getattr(self, name))

    @property
    def _fast_device(self):
        """The device chain applies when both backends are on the device and
        the default drain-pits mode is in effect."""
        return (self.conditioning_backend == "device"
                and self.pit_backend == "device"
                and self.drain_pits)

    def _connectivity_pits(self):
        kw = dict(max_iter=self.drain_pits_max_iter,
                  max_dist=self.drain_pits_max_dist,
                  max_dist_XY=self.drain_pits_max_dist_XY,
                  min_border=self.drain_pits_min_border)
        if self.pit_backend == "device":
            return connectivity_pits_device(
                self.flats, self.elev, self.mag, self.dX, self.dY,
                device=self.device, **kw)
        return cond.connectivity_pits(self.flats, self.elev, self.mag,
                                      self.dX, self.dY, **kw)

    def _drain_links(self):
        """Sparse (src, dst, weight) drain links + updated flats/mag for the
        configured pit/flat mode, with the reference's mode precedence
        (dem_processing.py:1094-1124: drain_pits, elif drain_flats, elif
        drain_pits_spill)."""
        if self.drain_pits:
            return self._connectivity_pits()
        if self.drain_flats:
            return cond.connectivity_flats(self.flats, self.elev, self.mag,
                                           self.dX)
        if self.drain_pits_spill:
            return cond.connectivity_pits_spill(
                self.section, self.flats, self.elev, self.mag,
                self.dX, self.dY,
                max_iter=self.drain_pits_max_iter,
                max_dist=self.drain_pits_max_dist,
                max_dist_XY=self.drain_pits_max_dist_XY)
        z = np.zeros(0)
        return z.astype("int64"), z.astype("int64"), z, self.flats, self.mag

    def _pruned_links_dev(self, pit_src, pit_dst, pit_w):
        """Host link triples pruned to weights > 1e-8 (adjacency pruning,
        dem_processing.py:1136) and uploaded; ``(None, None, None)`` when
        none is left."""
        keep = pit_w > 1e-8
        if not keep.any():
            return None, None, None
        return (self._to_dev(pit_src[keep]), self._to_dev(pit_dst[keep]),
                self._to_dev(pit_w[keep]))

    # -- persistence (dem_processing.py:260-303) ---------------------------

    def get_fn(self, name=None):
        from .geometry import get_fn_from_coords

        if not self.bounds:
            raise ValueError("processor has no bounds (constructed from an "
                             "in-memory array)")
        left, bottom, right, top = self.bounds
        return get_fn_from_coords((bottom, left, top, right), name)

    def get_full_fn(self, name, rootpath="."):
        import os

        return os.path.join(rootpath, name, self.get_fn(name))

    def save_array(self, fn, name):
        np.savez_compressed(fn + ".npz", getattr(self, name))

    def load_array(self, fn, name):
        """Load a previously saved field ('elev', 'mag', 'direction', 'uca',
        'twi') from <fn>.npz."""
        import os

        if not os.path.exists(fn + ".npz"):
            raise RuntimeError("File %s does not exist." % (fn + ".npz"))
        with np.load(fn + ".npz") as arr:
            setattr(self, name, arr["arr_0"])

    def load_elevation(self, fn):
        self.load_array(fn, "elev")

    def load_slope(self, fn):
        self.load_array(fn, "mag")

    def load_direction(self, fn):
        self.load_array(fn, "direction")

    def load_uca(self, fn):
        self.load_array(fn, "uca")

    # -- conditioning ------------------------------------------------------

    def calc_fill_flats(self):
        kw = dict(source_tol=self.fill_flats_source_tol,
                  fill_peaks=self.fill_flats_peaks,
                  fill_pits=self.fill_flats_pits,
                  below_sea=self.fill_flats_below_sea,
                  maximum_pit_area=self.maximum_pit_area)
        if self.conditioning_backend == "device":
            self.elev = fill_flats_device(self._to_dev(self.elev),
                                          **kw).cpu().numpy()
        else:
            self.elev = cond.fill_flats(self.elev, **kw)
        return self.elev

    def calc_pit_drain_paths(self):
        self.elev = cond.drain_pit_paths(
            self.elev, self.dX, self.dY,
            max_iter=self.drain_pits_max_iter,
            max_dist=self.drain_pits_max_dist,
            max_dist_XY=self.drain_pits_max_dist_XY,
            below_sea=self.fill_flats_below_sea,
        )
        return self.elev

    # -- slope / direction -------------------------------------------------

    def calc_slopes_directions(self):
        if self._fast_device:
            self._slopes_device()
            return self.mag, self.direction

        if self.fill_flats:
            self.calc_fill_flats()
        if self.drain_pits_path:
            self.calc_pit_drain_paths()

        mag, direction, flats = _slope_program(
            self._to_dev(self.elev), self._to_dev(self.dX),
            self._to_dev(self.dY))

        self.mag = mag.cpu().numpy()
        self.direction = direction.cpu().numpy()
        self.flats = flats.cpu().numpy()
        return self.mag, self.direction

    # -- the device chain --------------------------------------------------
    #
    # Three device stages (fill flats, slope+section, UCA+updates) with two
    # host crossings: the serial pit-path carve (C++ on the host elevation,
    # only when the device finds a pit) and the pit-link count.

    def _slopes_device(self):
        """Condition + slope/direction/flats/section on the device."""
        elev_d = self._to_dev(self.elev)
        _probe("elev_upload", elev_d)
        if self.fill_flats:
            elev_d = fill_flats_device(
                elev_d,
                source_tol=self.fill_flats_source_tol,
                fill_peaks=self.fill_flats_peaks,
                fill_pits=self.fill_flats_pits,
                below_sea=self.fill_flats_below_sea,
                maximum_pit_area=self.maximum_pit_area,
            )
            _probe("fill_flats_device", elev_d)
        if self.drain_pits_path and bool(_has_pits_program(
                elev_d, below_sea=self.fill_flats_below_sea)):
            # the carve needs the whole canvas on the host; only the pixels
            # it changed go back
            _probe("pit_gate")
            down = elev_d.cpu().numpy()
            _probe("carve_download")
            elev_np = cond.drain_pit_paths(
                down, self.dX, self.dY,
                max_iter=self.drain_pits_max_iter,
                max_dist=self.drain_pits_max_dist,
                max_dist_XY=self.drain_pits_max_dist_XY,
                below_sea=self.fill_flats_below_sea,
            )
            _probe("carve_host_kernel")
            with np.errstate(invalid="ignore"):
                # NaN != NaN is True; no-data pixels are never carved
                changed = np.flatnonzero((elev_np != down) & ~np.isnan(down))
            if changed.size:
                vals = elev_np.ravel()[changed].astype(down.dtype)
                elev_d = _apply_carve_delta(
                    elev_d, torch.from_numpy(changed).to(self.device),
                    torch.from_numpy(vals).to(self.device))
            _probe("carve_delta_upload", elev_d)
            self.__dict__["_np_elev"] = elev_np
            self.__dict__["_dev_elev"] = elev_d
        else:
            _probe("pit_gate")
            self._set_dev("elev", elev_d)

        mag, direction, flats, section, proportion = _pre_program(
            elev_d, self._to_dev(self.dX), self._to_dev(self.dY))
        _probe("pre_program", section)
        for k, v in (("mag", mag), ("direction", direction),
                     ("flats", flats), ("section", section),
                     ("proportion", proportion)):
            self._set_dev(k, v)

    def _calc_uca_device(self, fetch=True):
        if self._dev("section") is None:
            self._slopes_device()
        elev_d = self._field_dev("elev")

        packed = pit_links_device_packed(
            self._dev("flats"), elev_d, self.dX, self.dY,
            max_iter=self.drain_pits_max_iter,
            max_dist=self.drain_pits_max_dist,
            max_dist_XY=self.drain_pits_max_dist_XY,
            min_border=self.drain_pits_min_border)
        _probe("pit_links", None if packed is None else packed["wgt"])
        if packed is not None:
            if packed["n_warn"]:
                warnings.warn("%d pits had no place to drain to in this "
                              "chunk" % packed["n_warn"])
            links = (packed["src"], packed["dst"], packed["wgt"])
            drained = (packed["drained_idx"], packed["drained_mag"])
            has_pits, has_drained = packed["n_links"] > 0, True
        else:  # no pits at all
            links, drained = (None, None, None), (None, None)
            has_pits = has_drained = False

        area, n_sweeps, min_area, edge_todo, flats2, mag2 = \
            _uca_chain_program(
                elev_d, self._dev("section"), self._dev("proportion"),
                self._dev("flats"), self._dev("mag"),
                self._to_dev(self.dX2), self._to_dev(self.dY2),
                *links, *drained, has_pits, has_drained, self.uca_max_iters,
                self.uca_check_every, solver=self._resolved_solver(),
                block_size=self.uca_block_size)
        _probe("uca_solve", area)
        self.uca_sweeps = n_sweeps
        # fold a still-pending previous solve's min_area (the reference
        # keeps min(self.twi_min_area, min_area) over calc_uca calls)
        prev_pending = self.__dict__.get("_min_area_dev")
        if prev_pending is not None:
            min_area = torch.minimum(prev_pending, min_area)
        self.__dict__["_min_area_dev"] = min_area
        self._set_dev("uca", area)
        self._set_dev("mag", mag2)
        self._set_dev("flats", flats2)
        self._set_dev("edge_todo", edge_todo)
        # the flood behind edge_done sees the links the solve saw; min_area
        # stays on the device until edge_done is read
        self._edge_done = None
        self._edge_flood_args = (
            self._dev("section"), self._dev("proportion"),
            links if has_pits else (None, None, None), min_area)
        return self.uca if fetch else None

    def find_flats(self):
        self.flats = self.mag == FLAT_ID_INT

    # -- UCA ---------------------------------------------------------------

    def _use_device_chain(self):
        """The device chain runs a fresh solve unless the state came from
        the host (direction set, no section left on the device)."""
        return self._fast_device and (not self._has("direction")
                                      or self._dev("section") is not None)

    def calc_uca(self, plotflag=False, edge_init_data=None, uca_init=None):
        if uca_init is None and self._use_device_chain():
            return self._calc_uca_device()
        if self.direction is None:
            self.calc_slopes_directions()
        if uca_init is not None:
            return self._calc_uca_edge_update(edge_init_data, uca_init)

        section, proportion = _section_program(
            self._to_dev(self.direction), self._to_dev(self.flats),
            self._to_dev(self.dX), self._to_dev(self.dY))
        self.section = section.cpu().numpy()
        self.proportion = proportion.cpu().numpy()

        pit_src, pit_dst, pit_w, flats2, mag2 = self._drain_links()
        pits = self._pruned_links_dev(pit_src, pit_dst, pit_w)

        area, n_sweeps, min_area, edge_todo = _uca_program(
            self._to_dev(self.elev), section, proportion,
            self._to_dev(flats2), self._to_dev(self.dX2),
            self._to_dev(self.dY2), *pits, self.uca_max_iters,
            self.uca_check_every, solver=self._resolved_solver(),
            block_size=self.uca_block_size)
        self.uca_sweeps = n_sweeps
        self.twi_min_area = min(self.twi_min_area, float(min_area))

        self.uca = area.cpu().numpy()
        self.mag = np.asarray(mag2)
        self.flats = np.asarray(flats2)

        self.edge_todo = edge_todo.cpu().numpy()
        # edge_done needs the todo mask flooded downstream through the whole
        # drainage graph (an O(longest-path) sweep).  It only matters for
        # tile-based workflows, so it is computed on first access (see
        # :attr:`edge_done`).
        self._edge_done = None
        self._edge_flood_args = (section, proportion, pits, min_area)
        return self.uca

    @property
    def edge_done(self):
        """Per-pixel "no further cross-tile input pending" mask
        (dem_processing.py:973-980): the complement of the edge-todo mask
        flooded downstream, with masked pixels always done and, under
        ``apply_uca_limit_edges``, saturated pixels (uca > 2·limit·min_area)
        marked done as the large-domain early exit.  Computed on first
        access (an O(longest-flow-path) flood on the device)."""
        if self._edge_done is None and self._edge_flood_args is not None:
            section, proportion, pits, min_area = self._edge_flood_args
            flood = _edge_flood_program(
                self._field_dev("elev"), section, proportion,
                self._field_dev("edge_todo"), *pits)
            done = ~flood.cpu().numpy()
            # masked (no-data) pixels never await cross-tile input (:975)
            done[np.isnan(self.elev)] = True
            if self.apply_uca_limit_edges:
                # "2x because of bifurcations" (dem_processing.py:977-980)
                with np.errstate(invalid="ignore"):
                    done[self.uca > self.uca_saturation_limit * 2
                         * float(min_area)] = True
            self._edge_done = done
        return self._edge_done

    @edge_done.setter
    def edge_done(self, value):
        self._edge_done = value
        self._edge_flood_args = None

    def _calc_uca_edge_update(self, edge_init_data, uca_init):
        """Incremental cross-tile edge update: propagate only the *delta*
        area attributable to newly-finished neighbor edges.

        Functional port of the reference's tile edge-resolution pass
        (dem_processing.py:682-771 setup, :778-862 propagation) on the dense
        solver: already-initialized edge pixels are blocked from receiving
        (the ``done[row_id] & on_edge`` skip of cyutils.pyx:159-161) and the
        remaining todo-mask is flooded forward (drain_connections).  The
        masks are set up on the host in numpy, as in the JAX package; the
        two floods and the delta propagation run on the device.
        """
        shape = self.elev.shape
        edge_data, edge_init_done, edge_init_todo = edge_init_data
        init = np.zeros(shape, "float64")
        done = np.zeros(shape, bool)
        todo = np.zeros(shape, bool)
        sides = {"left": (slice(None), 0), "right": (slice(None), -1),
                 "top": (0, slice(None)), "bottom": (-1, slice(None))}
        for key, val in sides.items():
            done[val] |= np.asarray(edge_init_done[key]).reshape(done[val].shape)
            init[val] += (np.asarray(edge_data[key])
                          * np.asarray(edge_init_done[key])).reshape(init[val].shape)
            todo[val] |= np.asarray(edge_init_todo[key]).reshape(todo[val].shape)
        for key, val in sides.items():
            sel = init[val]
            sel[~done[val]] = 0
            init[val] = sel

        uca0 = np.asarray(uca_init, "float64")

        section, proportion = _section_program(
            self._to_dev(self.direction), self._to_dev(self.flats),
            self._to_dev(self.dX), self._to_dev(self.dY))
        self.section = section.cpu().numpy()
        self.proportion = proportion.cpu().numpy()

        pit_src, pit_dst, pit_w, flats2, mag2 = self._drain_links()
        pits = self._pruned_links_dev(pit_src, pit_dst, pit_w)
        has_pits = pits[0] is not None

        W = receiver_weights(section, proportion, self._to_dev(self.elev))

        # seed the delta: newly-done edges minus the area already counted
        ids0 = done & todo
        todo_active = todo & ~done
        delta0 = np.zeros(shape, "float64")
        delta0[done[:, 0], 0] = init[done[:, 0], 0] - uca0[done[:, 0], 0]
        delta0[done[:, -1], -1] = init[done[:, -1], -1] - uca0[done[:, -1], -1]
        delta0[-1, done[-1, :]] = init[-1, done[-1, :]] - uca0[-1, done[-1, :]]
        delta0[0, done[0, :]] = init[0, done[0, :]] - uca0[0, done[0, :]]
        delta0[flats2] = np.nan

        # Effective done-state (dem_processing.py:820-833): everything is
        # done except strict descendants of the seed set (drain_connections
        # flood), then the seeds themselves are re-marked done.  Edge pixels
        # that are done never receive (cyutils skip rule); pixels outside
        # seeds ∪ descendants are never activated so they never push.
        Wb = (W > 0).cpu().numpy()
        one_step = np.zeros(shape, bool)
        for k, (di, dj) in enumerate(NEIGHBOR_OFFSETS):
            src = Wb[k] & ids0
            tgt = np.zeros(shape, bool)
            si = slice(max(0, di), shape[0] + min(0, di))
            sj = slice(max(0, dj), shape[1] + min(0, dj))
            oi = slice(max(0, -di), shape[0] + min(0, -di))
            oj = slice(max(0, -dj), shape[1] + min(0, -dj))
            tgt[si, sj] = src[oi, oj]
            one_step |= tgt
        if has_pits:
            keep = pit_w > 1e-8
            flat_one = one_step.ravel()
            sel = ids0.ravel()[pit_src[keep]]
            flat_one[pit_dst[keep][sel]] = True
            one_step = flat_one.reshape(shape)
        reach1 = reachability(self._to_dev(one_step), W, *pits).cpu().numpy()

        edge = grid_edge_mask(shape).numpy()
        done_eff = ~reach1 | ids0
        # the masks in the solve's float dtype
        receive = self._to_dev(~(edge & done_eff)).to(self.dtype)
        push = self._to_dev(ids0 | reach1).to(self.dtype)
        delta, _n = accumulate_update(
            self._to_dev(delta0), W, receive, push, *pits,
            max_iters=self.uca_max_iters, check_every=self.uca_check_every)
        delta = delta.cpu().numpy()
        delta[flats2] = np.nan

        flooded = reachability(self._to_dev(todo_active), W, *pits)

        self.uca = uca0 + delta
        self.mag = np.asarray(mag2)
        self.flats = np.asarray(flats2)
        self.edge_todo = todo_active
        self.edge_done = ~flooded.cpu().numpy()
        return self.uca

    # -- TWI ---------------------------------------------------------------

    def calc_twi(self):
        if not self._has("uca"):
            if self._use_device_chain():
                self._calc_uca_device(fetch=False)
            else:
                self.calc_uca()
        if (self._dev("uca") is not None and self._dev("mag") is not None
                and self.__dict__.get("_np_uca") is None
                and self.__dict__.get("_np_mag") is None):
            # uca/mag never left the device (a fetched numpy view may have
            # been edited in place; then the host formula below is the truth)
            uca_d, mag_d = self._dev("uca"), self._dev("mag")
            twi10 = _twi_program(
                uca_d, mag_d, self._twi_min_area_device(uca_d),
                self.twi_min_slope, self.uca_saturation_limit,
                self.apply_twi_limits_on_uca, self.apply_twi_limits)
            _probe("twi_program", twi10)
            self._set_dev("twi", twi10)
            out = twi10.cpu().numpy() / 10
            _probe("twi_download")
            return out
        min_area = self.twi_min_area
        min_slope = self.twi_min_slope
        twi = self.uca.copy()
        if self.apply_twi_limits_on_uca:
            twi[twi > self.uca_saturation_limit * min_area] = \
                self.uca_saturation_limit * min_area
        with np.errstate(invalid="ignore", divide="ignore"):
            twi = np.log(twi / (self.mag + min_slope))
        if self.apply_twi_limits:
            sat = np.log(self.uca_saturation_limit * min_area / min_slope)
            twi[twi > sat] = sat
        # stored ×10, returned unscaled, as the reference does
        # (dem_processing.py:1662-1677)
        self.twi = twi * 10
        return twi

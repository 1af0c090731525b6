"""Single-tile API: :class:`DEMProcessor`, the device chain.

Port of ``pydem_tpu/api.py``'s device fast path: with
``conditioning_backend="device"`` and ``pit_backend="device"`` the whole
chain runs on the processor's ``device`` (flat filling, pit gate, the host
carve's delta, slope/flats/section, pit links, the UCA fixed point, TWI).
Only the pit carve runs on the host, in C++ (:mod:`pydem_tpu_torch.native`),
and only the carved pixels travel back.  State arrays stay on the device and
their numpy views are fetched on first read (:class:`_Field`).

Same constructor conventions, tunables, defaults and ``CONFIG_KEYS`` as the
JAX package, plus ``device`` (default ``"cuda"``; never chosen by what is
available: without a GPU the constructor raises, and the CPU is used only
when asked for with ``device="cpu"``).  Floats are :func:`pydem_tpu_torch.default_dtype` of the device.

Not ported yet (ROADMAP queue 1 item 4), each raising
``NotImplementedError``: the host conditioning and host pit backends, the
``drain_flats``/``drain_pits_spill`` modes (``drain_pits=False``), the tile
edge update (``calc_uca(uca_init=...)``), ``edge_done``, reading rasters
(``elev_fn``) and saving/loading arrays.

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
from .core.conditioning import drain_pit_paths
from .core.flats_device import fill_flats_device
from .core.receivers import receiver_weights, section_proportion
from .core.slope_direction import find_flats_edges, slopes_directions
from .core.stencil import NEIGHBOR_OFFSETS, shift
from .core.uca import accumulate, base_area, finalize_uca, seeds_and_edge_todo
from .ops.pit_growth import pit_links_device_packed
from .parallel.sharded import _block_size

FLAT_ID_INT = -1

# Instrumentation hook: when set, called at the device chain's stage
# boundaries as hook(name, tensor_or_None).  None in production.
_stage_probe = None


def _probe(name, val=None):
    if _stage_probe is not None:
        _stage_probe(name, val)


def _not_ported(what):
    return NotImplementedError(
        "pydem_tpu_torch.DEMProcessor: %s is not ported yet (ROADMAP queue 1 "
        "item 4); use conditioning_backend='device', pit_backend='device' "
        "and drain_pits=True" % what)


def _nanmin(a):
    return torch.where(torch.isnan(a), torch.inf, a).min()


def _pre_program(elev, dX, dY):
    """slope/direction + flats + section/proportion."""
    mag, direction = slopes_directions(elev, dX, dY)
    flats = find_flats_edges(elev, mag)
    direction = torch.where(flats, FLAT_ID_INT, direction)
    mag = torch.where(flats, FLAT_ID_INT, mag)
    section, proportion = section_proportion(direction, flats, dX, dY)
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
    # "host" (not ported yet) or "device"
    conditioning_backend = "host"
    pit_backend = "host"
    # "jacobi" = global sweeps; "blocked" = block rounds (the CUDA kernel on
    # a GPU); "auto" = blocked on CUDA with min(n, m) >= 256, else jacobi
    uca_solver = "auto"
    # block size for the blocked solver (None = 64, or 16 below 64 px)
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
        if elev_fn:
            raise _not_ported("reading a raster (elev_fn)")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DEMProcessor(device=%r): torch.cuda is not "
                               "available" % (device,))
        self.dtype = default_dtype(self.device)

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
        n, m = self.elev.shape
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
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    @property
    def _fast_device(self):
        """The device chain applies when both backends are on the device and
        the default drain-pits mode is in effect."""
        return (self.conditioning_backend == "device"
                and self.pit_backend == "device"
                and self.drain_pits)

    def _require_fast_device(self):
        if not self._fast_device:
            raise _not_ported(
                "conditioning_backend=%r, pit_backend=%r, drain_pits=%r (the "
                "host backends and the drain_flats/drain_pits_spill modes)"
                % (self.conditioning_backend, self.pit_backend,
                   self.drain_pits))

    # -- persistence (not ported) ------------------------------------------

    def save_array(self, fn, name):
        raise _not_ported("save_array")

    def load_array(self, fn, name):
        raise _not_ported("load_array")

    # -- slope / direction -------------------------------------------------

    def calc_slopes_directions(self):
        self._require_fast_device()
        self._slopes_device()
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
            elev_np = drain_pit_paths(
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
        elev_d = self._dev("elev")
        if elev_d is None:
            elev_d = self._to_dev(self.elev)

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
        return self.uca if fetch else None

    # -- UCA ---------------------------------------------------------------

    def calc_uca(self, plotflag=False, edge_init_data=None, uca_init=None):
        if uca_init is not None:
            raise _not_ported("the tile edge update (calc_uca(uca_init=...))")
        self._require_fast_device()
        if self._has("direction") and self._dev("section") is None:
            raise _not_ported("calc_uca from host-side direction/flats")
        return self._calc_uca_device()

    @property
    def edge_done(self):
        raise _not_ported("edge_done")

    # -- TWI ---------------------------------------------------------------

    def calc_twi(self):
        if not self._has("uca"):
            self._require_fast_device()
            if self._has("direction") and self._dev("section") is None:
                raise _not_ported("calc_uca from host-side direction/flats")
            self._calc_uca_device(fetch=False)
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

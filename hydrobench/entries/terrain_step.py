"""``pydem_tpu_torch.parallel.sharded.terrain_step`` on one tile.

The elevation goes up as a tensor in the program's type for the device
(float32 on a card), the step runs with the configuration's
``entry_args`` (the blocked solver), and ``uca`` and ``twi`` come back to
the host.  A tile drawn for the output check also brings back ``mag``,
``direction`` and ``flats``.
"""
from __future__ import annotations

import torch

PLANES = ("mag", "direction", "flats", "uca", "twi")
PRODUCTS = ("uca", "twi")
# traced runs: span -> the module attributes wrapped for it
SPANS = {"stencil": [("pydem_tpu_torch.parallel.sharded", "terrain_pre")],
         "uca_solve": [("pydem_tpu_torch.ops.uca_block",
                        "accumulate_blocked_gs")]}


class Entry:
    def __init__(self, config, spacing, device):
        from pydem_tpu_torch import default_dtype
        from pydem_tpu_torch.parallel import sharded

        self.step = sharded
        self.device = torch.device(device)
        self.dtype = default_dtype(self.device)  # float32 on the card
        self.spacing = spacing
        self.kwargs = config["entry_args"]

    def run(self, tile, keep=False):
        """``(host planes, counters)`` of one tile."""
        elev = torch.from_numpy(tile).to(self.device, self.dtype)
        out = self.step.terrain_step(elev, *self.spacing, **self.kwargs)
        planes = {k: out[k].cpu().numpy() for k in (PLANES if keep
                                                   else PRODUCTS)}
        return planes, {"uca_rounds": int(out["uca_sweeps"])}

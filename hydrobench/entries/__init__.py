"""Entry adapters, one a configuration's ``entry``: each drives the
program's user-facing call on one tile, host array in and host products
out, as its users call it."""

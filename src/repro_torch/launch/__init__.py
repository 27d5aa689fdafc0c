"""Drivers: ``steps`` (the prefill and decode steps), ``serve`` (the
batched serving CLI), ``surf_serve`` and ``surf_earlyexit`` (the SURF
serving and early-exit benches), and ``mesh`` (the named device grids
the multi-device SURF paths run on)."""

"""Hand-written Hopper kernels of the port, one package each.

The packages: ``flash_attention``, ``graph_filter``, ``ssm_scan`` (each
imported by its users, so that importing one builds nothing of another).
"""

"""The sweep kernels (CUDA, built at first use), their plain versions and
the search backends around them: ``p2h_scan`` (one tree, K1) and
``stacked_sweep`` (every sealed segment of a snapshot, K2)."""
